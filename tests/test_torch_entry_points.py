"""The port's host entry points and examples on the CPU against the JAX
package's: ``launch/serve.py --green-route``, ``launch/dryrun.py --plan``
and the four examples.

Each port entry point runs with ``--device cpu``; its standard output must
equal the reference's, captured the same way (the reference's examples
through ``runpy``, as scripts).  The training example cannot match the
reference's loss curve (torch cannot draw ``jax.random``'s init), so it
is run to the end of its own asserts instead.
"""
import os
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.examples import (
    green_cluster_sim, migrate_across_sites, quickstart, train_micro_lm,
)
from repro_torch.launch import dryrun as port_dryrun
from repro_torch.launch import serve as port_serve
from repro_torch.optim.adamw import init_opt_state

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")


def _ref_script(name, argv, monkeypatch, capsys):
    """Run the reference's ``examples/<name>.py`` as a script; its stdout."""
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
    capsys.readouterr()
    runpy.run_path(os.path.join(EXAMPLES, name + ".py"), run_name="__main__")
    return capsys.readouterr().out


def _port_main(main, argv, capsys):
    capsys.readouterr()
    main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--green-route", "64"],
    ["--green-route", "64", "--origin", "0", "--min-gbps", "5", "--lookahead-h", "0"],
], ids=["default", "origin-min-gbps-reactive"])
def test_green_route_matches_reference(argv, capsys):
    from repro.launch import serve as ref_serve

    capsys.readouterr()
    assert ref_serve.main(argv) == 0
    want = capsys.readouterr().out
    got = _port_main(port_serve.main, argv, capsys)
    assert got == want
    assert "served=64/64" in got


@pytest.fixture
def ref_dryrun(monkeypatch):
    """The reference's dryrun module.  Importing it sets a 512-device XLA
    flag and REPRO_UNROLL_SCAN for its lowering half; both are put back
    after the test."""
    for key in ("XLA_FLAGS", "REPRO_UNROLL_SCAN"):
        monkeypatch.setenv(key, os.environ.get(key, ""))
    from repro.launch import dryrun

    return dryrun


@pytest.mark.parametrize("argv", [["--plan"], ["--plan", "--transfers", "0:2,0:3"]],
                         ids=["plan", "plan-under-transfers"])
def test_dryrun_plan_matches_reference(argv, ref_dryrun, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["dryrun", *argv])
    capsys.readouterr()
    assert ref_dryrun.main() == 0
    want = capsys.readouterr().out
    got = _port_main(port_dryrun.main, argv, capsys)
    assert got == want
    assert "Migrate(" in got


def test_dryrun_without_plan_lowers_a_cell(tmp_path):
    """``main`` without --plan lowers a cell: whisper-tiny's decode_32k on
    the 16 x 16 fake world, traced on the CPU, in its own process (the fake
    world is process-global)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(EXAMPLES), "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny", "--shape",
         "decode_32k", "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[dryrun] whisper-tiny" in out.stdout and " single OK t_comp=" in out.stdout
    assert out.stdout.strip().endswith("done: 1 OK, 0 SKIP, 0 FAIL")
    assert os.path.exists(tmp_path / "baseline_single_whisper-tiny_decode_32k.json")


def test_quickstart_matches_reference(monkeypatch, capsys):
    want = _ref_script("quickstart", [], monkeypatch, capsys)
    capsys.readouterr()
    actions = quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert [str(a) for a in actions] == ["Migrate(jid=0, dest=1)"]


@pytest.mark.parametrize("argv", [["--scenario", "train-plus-serve", "--days", "1"], ["--list"]],
                         ids=["train-plus-serve-1-day", "list"])
def test_green_cluster_sim_matches_reference(argv, monkeypatch, capsys):
    want = _ref_script("green_cluster_sim", argv, monkeypatch, capsys)
    got = _port_main(green_cluster_sim.main, argv, capsys)
    assert got == want


def test_migrate_across_sites_matches_reference_from_jax_init(monkeypatch, capsys):
    """The reference's example from its own init; the port's ``run`` from
    the same init crossed as numpy: every size, ratio, class and
    transfer time printed is equal."""
    from repro.configs import get_config
    from repro.models import build_model

    want = _ref_script("migrate_across_sites", [], monkeypatch, capsys)
    cfg = get_config("micro-lm").reduced()
    ref_params = build_model(cfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")
    capsys.readouterr()
    sizes = migrate_across_sites.run({"params": params, "opt": init_opt_state(params)},
                                     device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert sizes["full"] > sizes["int8"] > sizes["delta-int8"] > 0


def test_train_micro_lm_demo_completes(capsys):
    """The demo trains site A to mid-run, gates, migrates, restores and
    finishes at site B; the example asserts the gate, the resumed step and
    the falling loss itself."""
    out = train_micro_lm.main(["--demo", "--steps", "12", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["site_a"]["status"] == "preempted" and out["site_a"]["step"] == 6
    assert out["site_b"]["status"] == "done" and out["site_b"]["step"] == 12
    assert [i.step for i in out["saves"]] == [6, 10, 12]
    assert out["saves"][0].nbytes == out["nbytes"] > 0
    assert "[example] OK: loss" in printed


@pytest.mark.parametrize("main,argv", [
    (port_serve.main, ["--green-route", "4"]),
    (port_dryrun.main, ["--plan"]),
    (quickstart.main, []),
    (green_cluster_sim.main, ["--days", "1"]),
    (migrate_across_sites.main, []),
    (train_micro_lm.main, ["--demo", "--steps", "2"]),
], ids=["serve", "dryrun", "quickstart", "green_cluster_sim", "migrate_across_sites",
        "train_micro_lm"])
def test_entry_points_default_to_the_card(main, argv):
    """Without ``--device`` an entry point asks for the card, and raises
    without one: none falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_draw_weights_on_their_device(launcher, monkeypatch, capsys):
    """``launch.serve`` and ``launch.train`` draw the model's weights with
    a generator made on the device they run on (seeded by ``--seed`` /
    ``TrainerConfig.seed``), not the CPU generator that ``Model.init``
    uses by default.  Here on the CPU: every generator made is recorded
    with the device it was asked for, the launcher's device is checked
    where ``resolve`` gives it, and ``Model.init`` is watched for the
    generator it draws with."""
    from repro_torch.launch import train as port_train
    from repro_torch.models.model import Model

    made, resolved, drawn = [], [], []
    real_generator, real_init = torch.Generator, Model.init

    def generator(*args, **kw):
        made.append(kw.get("device", args[0] if args else None))
        return real_generator(*args, **kw)

    def init(self, seed=0, *, device=None, generator=None):
        drawn.append((generator, device))
        return real_init(self, seed, device=device, generator=generator)

    mod = port_serve if launcher == "serve" else port_train
    real_resolve = mod.resolve

    def resolve(dev):
        resolved.append(real_resolve(dev))
        return resolved[-1]

    monkeypatch.setattr(torch, "Generator", generator)
    monkeypatch.setattr(Model, "init", init)
    monkeypatch.setattr(mod, "resolve", resolve)
    if launcher == "serve":
        argv = ["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                "--tokens", "2", "--seed", "3"]
    else:
        argv = ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "1", "--seq", "8",
                "--save-every", "10"]
    assert mod.main(argv) == 0
    capsys.readouterr()
    assert resolved == [torch.device("cpu")]
    (gen, device), = drawn
    assert gen is not None and gen.device == device == resolved[0]
    assert resolved[0] in made  # the generator was asked for on the launcher's device
    seed = 3 if launcher == "serve" else 0
    assert gen.initial_seed() == seed
