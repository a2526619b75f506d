"""Cells of the benchmark cut to a size the CPU tests run in seconds."""
import dataclasses
from pathlib import Path

import torch

from perfbench import bench

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, intermediate_size=64, vocab_size=256)
LOOSE = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "codes_diff": 0,
         "restore_diff": 0, "resume_loss_gap": 1e-3, "resume_grad_gap": 1e-3,
         "resume_change_gap": 1e-2, "route_gap": 1e-2, "rerun_route_diff": 0}


def small_cell(name: str, dtype: str = "float32", limits=None, **mix):
    cell = bench.resolve_cell(ROOT, name, listed=False)
    cfg = dict(cell.config, **SMALL, torch_dtype=dtype)
    if cfg.get("num_local_experts"):
        cfg.update(num_local_experts=4, num_experts_per_tok=2)
    m = dict(cell.mix, batch=2, seq=32, pool=8, reference_rows=1, **mix)
    if "controls_steps" in m:
        m["controls_steps"] = 1
    return dataclasses.replace(cell, config=cfg, mix=m, limits=dict(LOOSE, **(limits or {})))


def few_threads():
    torch.set_num_threads(2)
