"""int8 quantize / dequantize on the card: wrappers of ``csrc/quantize.cu``.

Replaces ``quantize_int8_pallas`` and ``dequantize_int8_pallas``
(``repro/kernels/quantize.py``).  The plain versions are
``kernels/ref.py::quantize_int8_ref`` / ``dequantize_int8_ref``; the CUDA
kernels are bit-identical to them (see the source note).  Each wrapper
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

BLOCK = 256  # the kernels' quantization group; the serializer's BLOCK


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise NotImplementedError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be flat and contiguous, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def quantize_int8_cuda(x: torch.Tensor, *, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: flat f32 (n,), n % 256 == 0 -> (q int8 (n,), scales f32 (n/256,))."""
    _check(x, torch.float32, "x")
    if block != BLOCK or x.numel() % BLOCK:
        raise ValueError(f"the kernel quantizes groups of {BLOCK}; got block={block}, n={x.numel()}")
    groups = x.numel() // BLOCK
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((groups,), dtype=torch.float32, device=x.device)
    lib = _build.load()
    err = lib.repro_quantize_int8_f32(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), groups, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_int8")
    quantize_int8_cuda.launches += 1
    return q, scale


def dequantize_int8_cuda(q: torch.Tensor, scale: torch.Tensor, *, block: int = BLOCK) -> torch.Tensor:
    """q int8 (n,), scales f32 (n/256,) -> x f32 (n,)."""
    _check(q, torch.int8, "q")
    _check(scale, torch.float32, "scale")
    n = q.numel()
    if block != BLOCK or n % BLOCK or scale.numel() != n // BLOCK:
        raise ValueError(f"need n % {BLOCK} == 0 and n/{BLOCK} scales; got block={block}, "
                         f"n={n}, scales={scale.numel()}")
    if scale.device != q.device:
        raise ValueError("q and scale must lie on one device")
    x = torch.empty((n,), dtype=torch.float32, device=q.device)
    lib = _build.load()
    err = lib.repro_dequantize_int8_f32(
        q.data_ptr(), scale.data_ptr(), x.data_ptr(), n, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "dequantize_int8")
    dequantize_int8_cuda.launches += 1
    return x


quantize_int8_cuda.launches = 0
dequantize_int8_cuda.launches = 0
