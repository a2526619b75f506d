"""The routed experts' MLP on the card: wrappers of ``csrc/grouped_gemm.cu``
(K5) and the ``torch.autograd.Function`` that trains through it.

K5 replaces no TPU kernel: the JAX package runs every token through every
expert with XLA's einsums (``repro/models/moe.py``, the dense dispatch).
The port sorts the routed rows by expert (``models/moe.py``) and K5 runs
each expert's SwiGLU MLP on its own rows: ``grouped_mlp_cuda(xs, wg, wi,
wo, offsets)`` is, for each group e, ``(act(xs_e wg_e) * (xs_e wi_e)) wo_e``
with xs_e = xs[offsets[e]:offsets[e + 1]].  The offsets stay on the card;
nothing reads a group's size on the host.  Its plain version is
``kernels/ref.py::grouped_mlp_ref`` (a loop of ``torch.matmul`` over the
groups).  float32 or bfloat16 (float32 accumulation), activation silu.

A forward is two launches (the gate and up projections with the SwiGLU
product, then the down projection), a backward five (dh with the SwiGLU
derivative, dW of the down projection, dx, dW of the gate and of the up
projection); each counts under ``launch.grouped_gemm``.  Rows of ``xs``
outside every group (the other experts' rows, on a block of experts) are
0 in the output and in dx.

Beside it, ``csrc/moe_rows.cu``'s row sums over the sorted rows, each
launch counted under ``launch.moe_rows``: ``moe_rows_sum_cuda`` (a token's
k rows, weighted by its float32 gates: the combine; or unweighted: the
gradient of the dispatch's gather) and ``moe_combine_bwd_cuda`` (the
combine's backward).  Their plain versions are ``kernels/ref.py``'s
``moe_rows_sum_ref`` and ``moe_combine_bwd_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _traced

KINDS = {"fwd_glu": 0, "fwd": 1, "dgrad_glu": 2, "dgrad": 3, "wgrad": 4}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = ("silu",)
MAX_GROUPS = 256  # csrc/grouped_gemm.cu's kMaxGroups
MAX_TOP_K, MAX_ROW_BYTES = 16, 8 * 128 * 16  # csrc/moe_rows.cu's kMaxK, its longest row


def _on_card(x: torch.Tensor) -> None:
    """A kernel takes CUDA tensors (fake ones trace through its custom op)."""
    if not (x.is_cuda or isinstance(x, FakeTensor)):
        raise ValueError(f"the kernel takes CUDA tensors, got one on {x.device}")


def check_inputs(xs, wg, wi, wo, offsets, act: str, num_experts: int) -> None:
    """Raise on what K5 does not take."""
    _on_card(xs)
    rows, d = xs.shape
    groups, _, f = wg.shape
    if act not in ACTS:
        raise NotImplementedError(f"K5's epilogue computes {ACTS}, not {act!r}")
    for name, t in (("xs", xs), ("wg", wg), ("wi", wi), ("wo", wo)):
        if t.device != xs.device or t.dtype != xs.dtype or t.dtype not in DTYPES:
            raise ValueError(f"xs and the expert weights must all be float32 or all bfloat16 on "
                             f"{xs.device}; {name} is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(wi.shape) != (groups, d, f) or tuple(wo.shape) != (groups, f, d):
        raise ValueError(f"expert weights: wg {tuple(wg.shape)}, wi {tuple(wi.shape)}, "
                         f"wo {tuple(wo.shape)} for rows of {d}")
    if d % 8 or f % 8:
        raise NotImplementedError(f"K5 copies 16-byte rows: d {d} and f {f} must divide by 8")
    if not 1 <= groups <= MAX_GROUPS or groups > num_experts:
        raise ValueError(f"{groups} groups of {num_experts} experts (at most {MAX_GROUPS})")
    if (offsets.device != xs.device or offsets.dtype != torch.int64
            or tuple(offsets.shape) != (groups + 1,) or not offsets.is_contiguous()):
        raise ValueError(f"offsets must be contiguous int64 ({groups + 1},) on {xs.device}")


def _launch(kind: str, a, lda, b0, b1, ldb, b_stride, b_ksplit, c, ldc, c_stride, aux, ld_aux,
            offsets, groups, M, N, K) -> None:
    """One K5 launch; b0, b1, aux are data pointers (ints), the rest as named."""
    err = _build.load().repro_grouped_gemm(
        KINDS[kind], DTYPES[a.dtype], a.data_ptr(), lda, b0, b1, ldb, b_stride, b_ksplit,
        c.data_ptr(), ldc, c_stride, aux, ld_aux, offsets.data_ptr(), groups, M, N, K,
        a.device.index, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"grouped_gemm {kind}")
    spans.count("launch.grouped_gemm")


def _fill(whole: bool):
    """Buffers whose rows only some groups write are zeroed first."""
    return torch.empty if whole else torch.zeros


def _fwd_impl(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
              offsets: torch.Tensor, act: str, num_experts: int,
              save: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out rows, [g | u] for the backward or an empty tensor, h)."""
    rows, d = xs.shape
    groups, _, f = wg.shape
    kw = dict(dtype=xs.dtype, device=xs.device)
    h = torch.empty((rows, f), **kw)
    gu = torch.empty((rows, 2 * f) if save else (0,), **kw)
    out = _fill(groups == num_experts)((rows, d), **kw)
    _launch("fwd_glu", xs, d, wg.data_ptr(), wi.data_ptr(), f, d * f, d, h, f, 0,
            gu.data_ptr() if save else None, 2 * f, offsets, groups, rows, f, d)
    _launch("fwd", h, f, wo.data_ptr(), wo.data_ptr(), d, f * d, f, out, d, 0, None, 0,
            offsets, groups, rows, d, f)
    return out, gu, h


def _bwd_impl(dout: torch.Tensor, xs: torch.Tensor, gu: torch.Tensor, h: torch.Tensor,
              wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, offsets: torch.Tensor,
              act: str, num_experts: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dxs, dwg, dwi, dwo) for the output rows' cotangent ``dout``."""
    rows, d = xs.shape
    groups, _, f = wg.shape
    dgu = torch.empty((rows, 2 * f), dtype=xs.dtype, device=xs.device)
    dxs = _fill(groups == num_experts)((rows, d), dtype=xs.dtype, device=xs.device)
    dwg, dwi, dwo = torch.empty_like(wg), torch.empty_like(wi), torch.empty_like(wo)
    # [dg | du] = SwiGLU'(dout wo_e^T); dwo_e = h_e^T dout_e; dx = [dg | du] [wg_e | wi_e]^T;
    # dwg_e = xs_e^T dg_e, dwi_e = xs_e^T du_e
    _launch("dgrad_glu", dout, d, wo.data_ptr(), wo.data_ptr(), d, f * d, d, dgu, 2 * f, 0,
            gu.data_ptr(), 2 * f, offsets, groups, rows, f, d)
    _launch("wgrad", h, f, dout.data_ptr(), dout.data_ptr(), d, 0, 0, dwo, d, f * d, None, 0,
            offsets, groups, f, d, rows)
    _launch("dgrad", dgu, 2 * f, wg.data_ptr(), wi.data_ptr(), f, d * f, f, dxs, d, 0, None, 0,
            offsets, groups, rows, d, 2 * f)
    du = dgu.data_ptr() + f * dgu.element_size()
    for dw, b in ((dwg, dgu.data_ptr()), (dwi, du)):
        _launch("wgrad", xs, d, b, b, 2 * f, 0, 0, dw, f, d * f, None, 0,
                offsets, groups, d, f, rows)
    return dxs, dwg, dwi, dwo


# The entries are also custom ops, as K1's are (kernels/flash_attention.py):
# a fake tensor (the mesh dry-run) traces through them with no launch and
# FlopCounterMode counts them; an untraced call runs the implementation
# directly.  The launch counter counts in the implementations only.
_fwd_op = torch.library.custom_op("repro_torch::grouped_mlp_fwd", mutates_args=(),
                                  device_types="cuda")(_fwd_impl)
_bwd_op = torch.library.custom_op("repro_torch::grouped_mlp_bwd", mutates_args=(),
                                  device_types="cuda")(_bwd_impl)


@_fwd_op.register_fake
def _(xs, wg, wi, wo, offsets, act, num_experts, save):
    rows, f = xs.shape[0], wg.shape[-1]
    return (xs.new_empty((rows, wo.shape[-1])), xs.new_empty((rows, 2 * f) if save else (0,)),
            xs.new_empty((rows, f)))


@_bwd_op.register_fake
def _(dout, xs, gu, h, wg, wi, wo, offsets, act, num_experts):
    return torch.empty_like(xs), torch.empty_like(wg), torch.empty_like(wi), torch.empty_like(wo)


def _routed_share(wg, num_experts: int) -> float:
    """The share of the buffer's rows a block of experts computes, as the
    MoE's ``moe.rows_routed`` counts them (all of them on whole experts)."""
    return wg[0] / num_experts


# FLOP formulas get shapes (torch.Size) in place of the tensors.
@register_flop_formula(torch.ops.repro_torch.grouped_mlp_fwd)
def _fwd_flop_formula(xs, wg, wi, wo, offsets, act, num_experts, save, *args, out_val=None,
                      **kwargs) -> int:
    """Three products of 2 d f a routed row."""
    rows, d = xs
    return int(6 * rows * d * wg[-1] * _routed_share(wg, num_experts))


@register_flop_formula(torch.ops.repro_torch.grouped_mlp_bwd)
def _bwd_flop_formula(dout, xs, gu, h, wg, wi, wo, offsets, act, num_experts, *args,
                      out_val=None, **kwargs) -> int:
    """Twice the forward's: dh, dwo, dx over 2f, dwg and dwi."""
    rows, d = xs
    return int(12 * rows * d * wg[-1] * _routed_share(wg, num_experts))


def grouped_mlp_cuda(xs, wg, wi, wo, offsets, *, act: str = "silu", num_experts: int,
                     save: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's forward: (out rows, [g | u] if ``save`` else empty, h)."""
    check_inputs(xs, wg, wi, wo, offsets, act, num_experts)
    fwd = _fwd_op if _traced(xs) else _fwd_impl
    return fwd(xs, wg, wi, wo, offsets, act, int(num_experts), bool(save))


def grouped_mlp_bwd_cuda(dout, xs, gu, h, wg, wi, wo, offsets, *, act: str = "silu",
                         num_experts: int) -> Tuple[torch.Tensor, ...]:
    """K5's backward from the forward's saved [g | u] and h: (dxs, dwg, dwi, dwo)."""
    check_inputs(xs, wg, wi, wo, offsets, act, num_experts)
    rows, f = xs.shape[0], wg.shape[-1]
    for name, t, shape in (("dout", dout, (rows, wo.shape[-1])), ("gu", gu, (rows, 2 * f)),
                           ("h", h, (rows, f))):
        if t.device != xs.device or t.dtype != xs.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {xs.dtype} {shape} on {xs.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bwd = _bwd_op if _traced(xs) else _bwd_impl
    return bwd(dout, xs, gu, h, wg, wi, wo, offsets, act, int(num_experts))


class GroupedMLPFn(torch.autograd.Function):
    """K5 forward, K5 backward.  For CUDA tensors (and fake ones: the
    dry-run); the CPU differentiates the plain version with autograd.  The
    forward saves the rows, [g | u] and h; under activation checkpointing
    they are dropped and the forward reruns in the backward pass."""

    @staticmethod
    def forward(ctx, xs, wg, wi, wo, offsets, act: str, num_experts: int, save: bool):
        out, gu, h = grouped_mlp_cuda(xs, wg, wi, wo, offsets, act=act, num_experts=num_experts,
                                      save=save)
        ctx.save_for_backward(xs, wg, wi, wo, offsets, gu, h)
        ctx.kw = dict(act=act, num_experts=num_experts)
        return out

    @staticmethod
    def backward(ctx, dout):
        xs, wg, wi, wo, offsets, gu, h = ctx.saved_tensors
        grads = grouped_mlp_bwd_cuda(dout.contiguous(), xs, gu, h, wg, wi, wo, offsets, **ctx.kw)
        return (*grads, None, None, None, None)


# ---------------------------------------------------------------------------
# The row sums beside K5 (csrc/moe_rows.cu)
# ---------------------------------------------------------------------------


def _check_rows(src: torch.Tensor, inv: torch.Tensor, w: Optional[torch.Tensor], k: int) -> None:
    _on_card(src)
    if src.dim() != 2 or src.dtype not in DTYPES or not src.is_contiguous():
        raise ValueError(f"rows must be a contiguous float32 or bfloat16 matrix, got "
                         f"{src.dtype} {tuple(src.shape)}")
    d = src.shape[1]
    if (d * src.element_size()) % 16 or d * src.element_size() > MAX_ROW_BYTES:
        raise NotImplementedError(f"rows of {d} {src.dtype}: 16-byte chunks, at most "
                                  f"{MAX_ROW_BYTES} bytes")
    if not 1 <= k <= MAX_TOP_K or inv.dtype != torch.int64 or inv.dim() != 1 or inv.numel() % k:
        raise ValueError(f"inv must be int64 (tokens x {k},), k at most {MAX_TOP_K}")
    if w is not None and (w.dtype != torch.float32 or tuple(w.shape) != (inv.numel() // k, k)
                          or not w.is_contiguous()):
        raise ValueError(f"gates must be contiguous float32 ({inv.numel() // k}, {k})")
    for name, t in (("inv", inv), ("gates", w)):
        if t is not None and t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, the rows on {src.device}")


def _rows_sum_impl(src: torch.Tensor, inv: torch.Tensor, w: Optional[torch.Tensor],
                   k: int) -> torch.Tensor:
    tokens = inv.numel() // k
    dst = torch.empty((tokens, src.shape[1]), dtype=src.dtype, device=src.device)
    err = _build.load().repro_moe_rows_sum(
        src.data_ptr(), inv.data_ptr(), None if w is None else w.data_ptr(), dst.data_ptr(),
        tokens, k, src.shape[1], DTYPES[src.dtype], src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "moe_rows_sum")
    spans.count("launch.moe_rows")
    return dst


def _combine_bwd_impl(src: torch.Tensor, dy: torch.Tensor, inv: torch.Tensor,
                      w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens, k = w.shape
    dsrc, dw = torch.empty_like(src), torch.empty_like(w)
    err = _build.load().repro_moe_combine_bwd(
        src.data_ptr(), dy.data_ptr(), inv.data_ptr(), w.data_ptr(), dsrc.data_ptr(),
        dw.data_ptr(), tokens, k, src.shape[1], DTYPES[src.dtype], src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "moe_combine_bwd")
    spans.count("launch.moe_rows")
    return dsrc, dw


_rows_sum_op = torch.library.custom_op("repro_torch::moe_rows_sum", mutates_args=(),
                                       device_types="cuda")(_rows_sum_impl)
_combine_bwd_op = torch.library.custom_op("repro_torch::moe_combine_bwd", mutates_args=(),
                                          device_types="cuda")(_combine_bwd_impl)


@_rows_sum_op.register_fake
def _(src, inv, w, k):
    return src.new_empty((inv.shape[0] // k, src.shape[1]))


@_combine_bwd_op.register_fake
def _(src, dy, inv, w):
    return torch.empty_like(src), torch.empty_like(w)


def moe_rows_sum_cuda(src: torch.Tensor, inv: torch.Tensor, w: Optional[torch.Tensor],
                      k: int) -> torch.Tensor:
    """(tokens, d): y[t] = sum_j w[t, j] src[inv[t k + j]] in float32, in
    order, rounded once to src's type; ``w`` float32 (tokens, k) or None
    (weights of 1)."""
    _check_rows(src, inv, w, k)
    fn = _rows_sum_op if _traced(src) else _rows_sum_impl
    return fn(src, inv, w, int(k))


def moe_combine_bwd_cuda(src: torch.Tensor, dy: torch.Tensor, inv: torch.Tensor,
                         w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine's backward for y's cotangent ``dy`` (tokens, d):
    (dsrc[inv[t k + j]] = w[t, j] dy[t], dw[t, j] = <src[inv[t k + j]], dy[t]>
    in float32); ``inv`` a permutation of src's rows."""
    _check_rows(src, inv, w, w.shape[-1])
    if dy.dtype != src.dtype or tuple(dy.shape) != (w.shape[0], src.shape[1]) \
            or not dy.is_contiguous() or dy.device != src.device:
        raise ValueError(f"dy must be contiguous {src.dtype} ({w.shape[0]}, {src.shape[1]}), got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if inv.numel() != src.shape[0]:
        raise ValueError(f"inv ({inv.numel()},) must permute all {src.shape[0]} rows")
    fn = _combine_bwd_op if _traced(src) else _combine_bwd_impl
    return fn(src, dy, inv, w)
