"""The port's package boundary: it imports neither JAX nor the JAX package
(nor ``ml_dtypes``, JAX's numpy bfloat16, which the machine with the card
lacks), and without a card its default device raises instead of falling
back."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config
from repro_torch.models.model import build_model

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print(len(names), bad)
assert not bad, bad
assert {{"repro_torch.models.mamba", "repro_torch.models.xlstm", "repro_torch.models.encdec"}} <= set(names)
assert {{"repro_torch.parallel.sharding", "repro_torch.parallel.strategies", "repro_torch.parallel.compat",
        "repro_torch.launch.mesh", "repro_torch.launch.dryrun"}} <= set(names)
import torch.distributed as dist
assert not dist.is_initialized(), "importing the port initialized a process group"
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    src = os.path.abspath(os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(src=src, root=os.path.abspath(ROOT))],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module of the port was imported


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve()
    model = build_model(get_config("micro-lm").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_chip_smoke_exits_nonzero_without_card():
    """No card: chip_smoke.py fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
