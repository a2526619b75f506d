"""Checkpoint-migration microscope: serialize a real training state in all
three modes (full / int8 / delta-int8), push each through the WAN model at
several bandwidths, and show how compression moves the job across the
paper's feasibility classes — §VIII 'expanding the feasible envelope',
implemented (port of ``examples/migrate_across_sites.py``).  The int8
modes quantize with the K2 kernel on ``--device``.

  PYTHONPATH=src python -m repro_torch.examples.migrate_across_sites

``run(state)`` takes the initial training state ``{"params", "opt"}``, so
a caller can hand it one made elsewhere (the tests hand it the JAX
package's init, which torch cannot draw).  Its checkpoint directories are
removed when it returns.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serializer import serialize_tree, tree_bytes
from repro_torch.configs import get_config
from repro_torch.convert import tree_map
from repro_torch.core import feasibility as fz
from repro_torch.core.migration import migrate_job
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import build_model
from repro_torch.optim.adamw import init_opt_state

GB = 1e9


def _stepped(x):
    """x + 1e-3 for a float leaf, in its own type; any other leaf as is."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x + torch.tensor(1e-3, dtype=x.dtype, device=x.device)
    return x


def run(state, *, device: DeviceLike = None) -> dict:
    """The microscope on ``state`` (its tensors on ``device``).  Returns the
    serialized size of each mode."""
    dev = resolve(device)
    stepped = tree_map(_stepped, state)
    raw = tree_bytes(state)
    print(f"train state: {raw/1e6:.2f} MB raw")
    sizes = {
        "full": serialize_tree(stepped, mode="full", device=dev).nbytes,
        "int8": serialize_tree(stepped, mode="int8", device=dev).nbytes,
        "delta-int8": serialize_tree(stepped, mode="delta-int8", base=state, device=dev).nbytes,
    }
    print(f"{'mode':<12} {'bytes':>12} {'ratio':>7}   class @ 1Gbps for a 32B-model-scale state")
    for mode, n in sizes.items():
        scale = 32.8e9 * 14 / raw  # what this mode would weigh at qwen2.5-32b scale
        big = n * scale
        cls = "ABC"[int(fz.classify(big, 1e9))]
        print(f"{mode:<12} {n:>12,} {raw/n:>6.1f}x   {big/GB:8.1f} GB -> class {cls}")

    # real end-to-end migration of the checkpoint artifact
    with tempfile.TemporaryDirectory(prefix="greenflow_migrate_") as root:
        mgr = CheckpointManager(os.path.join(root, "A"), job="demo", mode="delta-int8")
        mgr.save(1, state)
        mgr.save(2, stepped)  # delta vs step-1 base
        print(f"\ndelta checkpoint on disk: {mgr.latest_bytes:,} bytes")
        for bw in (0.1e9, 1e9, 10e9):
            dst, rep = migrate_job(mgr, os.path.join(root, f"B{int(bw/1e6)}"),
                                   bandwidth_bps=bw, window_s=2.5 * 3600)
            print(f"  @{bw/1e9:5.1f} Gbps: T_transfer={rep.t_transfer_s:8.3f}s "
                  f"class={'ABC'[rep.workload_class]} feasible={rep.feasible_in_window}")
    return sizes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("micro-lm").reduced()
    params = build_model(cfg).init(0, device=device)
    return run({"params": params, "opt": init_opt_state(params)}, device=device)


if __name__ == "__main__":
    main()
