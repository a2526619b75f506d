"""Fused Algorithm-1 decide (K4) on the card: wrapper of ``csrc/decide.cu``.

Replaces ``_score_pallas`` (``repro/core/policy_kernels.py``).  The plain
version is ``kernels/ref.py::decide_dest_ref``; both compute in float64
and are bit-identical to the numpy pass ``_score_numpy`` (see the source
note).  The wrapper counts its launches in ``decide_dest_cuda.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

JOB_COLS, SITE_COLS = 6, 3


def check_decide_inputs(jobs: torch.Tensor, sites: torch.Tensor, bw: torch.Tensor) -> None:
    """Shapes and types both versions take: float64 jobs (B, K, 6),
    sites (B, S, 3) and bw (B, K, S) on one device."""
    for name, x in (("jobs", jobs), ("sites", sites), ("bw", bw)):
        if x.dtype != torch.float64:
            raise ValueError(f"{name} must be float64, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got {tuple(x.shape)}")
        if x.device != jobs.device:
            raise ValueError(f"{name} lies on {x.device}, jobs on {jobs.device}")
    B, K, S = bw.shape
    if jobs.shape != (B, K, JOB_COLS) or sites.shape != (B, S, SITE_COLS):
        raise ValueError(f"shape mismatch: jobs {tuple(jobs.shape)}, sites "
                         f"{tuple(sites.shape)}, bw {tuple(bw.shape)}")


def decide_dest_cuda(
    jobs: torch.Tensor, sites: torch.Tensor, bw: torch.Tensor, *,
    alpha: float, gamma: float, betaqp: float, queue_penalty_s: float,
    min_benefit_s: float, ppf_sigma: float, use_stoch: bool,
    energy_ratio: float, t_downtime_s: float, class_c_s: float,
) -> torch.Tensor:
    """(B, K) int64 argbest destinations, -1 = stay."""
    check_decide_inputs(jobs, sites, bw)
    if not jobs.is_cuda:
        raise ValueError(f"jobs must be a CUDA tensor, got {jobs.device}")
    for name, x in (("jobs", jobs), ("sites", sites), ("bw", bw)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, K, S = bw.shape
    dest = torch.empty((B, K), dtype=torch.int64, device=jobs.device)
    lib = _build.load()
    err = lib.repro_decide_dest_f64(
        jobs.data_ptr(), sites.data_ptr(), bw.data_ptr(), dest.data_ptr(),
        B, K, S, float(alpha), float(gamma), float(betaqp), float(queue_penalty_s),
        float(min_benefit_s), float(ppf_sigma), int(bool(use_stoch)),
        float(energy_ratio), float(t_downtime_s), float(class_c_s),
        jobs.device.index, torch.cuda.current_stream(jobs.device).cuda_stream)
    _build.check(err, "decide_dest")
    decide_dest_cuda.launches += 1
    return dest


decide_dest_cuda.launches = 0
