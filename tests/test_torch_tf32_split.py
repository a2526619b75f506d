"""The rounding design of the card's float32 flash attention (K1) and of its
backward, on the CPU.

The kernel runs both products on TF32 tensor cores with a 3xTF32 split:
each operand x becomes hi = tf32(x) and lo = tf32(x - hi), rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``), and a product is
lo*hi + hi*lo + hi*hi accumulated in float32.  Here the split is emulated
exactly (the rounding in numpy; the products of 11-bit mantissas, exact in
float32, with plain torch) and held against the plain float32 version at
the JAX package's own float32 tolerance, 2e-6, on every float32 shape
chip_smoke.py checks on the card.  Single TF32 (hi*hi alone) must miss it:
that is why the split exists.

What this does not model is the tensor cores' accumulation: here the sums
round to nearest in float32, while the card's mma truncates as it
accumulates.  So this test checks the rounding design only, not the
kernel's error.  On an H100 the kernel's max abs error against its plain
version on the same shapes is about 6.4e-6 (PERF.md), three times this
test's bound; chip_smoke.py holds it to FLASH_TOL = 1e-5.

The backward (csrc/flash_attention_bwd.cu) is emulated the same way: its
five products through ``matmul``, P = exp(x - lse) from the emulated
forward's log-sum-exp, D = rowsum(dO * O) from the emulated forward's
output, and dQ, dK, dV summed in float32 over fresh per-pass products of
the kernel's pass size (dK and dV across a GQA group's heads too).  It is
held to the plain version at 1e-5 of each gradient's largest element
(chip_smoke.py's GRAD_TOL, 1e-4, leaves room for the card's truncating
accumulation); single TF32 misses.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

TOL = 2e-6  # tests/test_kernels.py::SWEEP, float32 rows


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (10 explicit mantissa bits) in float32 storage, round
    to nearest, ties away from zero: add half of the dropped 13 bits' range
    to the magnitude, then clear them."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x.numpy())
    lo = tf32_rna(x.numpy() - hi)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with TF32 operands: 3 terms (the kernel's split) or 1."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def attention(q, k, v, *, mask_kind, window, attn_softcap, terms):
    """The kernel's arithmetic: scores and P.V through ``matmul``, scale,
    softcap, masks, float32 softmax with p = exp(x - max), out = acc / l."""
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    kh = k.repeat_interleave(nh // nkv, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(nh // nkv, dim=2).permute(0, 2, 1, 3)
    qh = q.permute(0, 2, 1, 3)
    sc = matmul(qh.contiguous(), kh.transpose(-1, -2).contiguous(), terms) * hd ** -0.5
    if attn_softcap:
        sc = attn_softcap * torch.tanh(sc / attn_softcap)
    if mask_kind != "full":
        qpos, kpos = torch.arange(s)[:, None], torch.arange(t)[None, :]
        ok = kpos <= qpos
        if mask_kind == "window" and window > 0:
            ok &= (qpos - kpos) < window
        sc = torch.where(ok, sc, torch.full((), ref.NEG_INF))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    out = matmul(p, vh.contiguous(), terms) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 2, 1, 3)


def _inputs(case, seed):
    b, s, t, nh, nkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, s, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd)))


CASES = chip_smoke.FLASH_CASES
assert any(c[5] == 256 for c in CASES)
# One each of causal, window + softcap, and full with t != s and GQA.
BWD_CASES = [(1, 200, 200, 4, 2, 32, "causal", 0, 0.0),
             (2, 512, 512, 6, 6, 64, "window", 256, 30.0),
             (1, 100, 300, 2, 1, 128, "full", 0, 0.0)]
assert all(c in chip_smoke.FLASH_BWD_CASES for c in BWD_CASES)
BWD_TOL = 1e-5


def _pass_rows(hd: int) -> int:
    """Streamed rows per register pass of the backward kernel (Bwd::kNC, float32)."""
    return 16 if hd == 256 else 32


def attention_bwd(q, k, v, do, *, mask_kind, window, attn_softcap, terms):
    """The backward kernel's arithmetic: (dq, dk, dv)."""
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g, scale, rows = nh // nkv, hd ** -0.5, _pass_rows(hd)
    kh = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
    vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
    qh, doh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, do))
    sc = matmul(qh, kh.transpose(-1, -2).contiguous(), terms) * scale
    dcap = torch.ones_like(sc)
    if attn_softcap:
        th = torch.tanh(sc / attn_softcap)
        sc, dcap = attn_softcap * th, 1 - th * th
    ok = torch.ones(s, t, dtype=torch.bool)
    if mask_kind != "full":
        qpos, kpos = torch.arange(s)[:, None], torch.arange(t)[None, :]
        ok = kpos <= qpos
        if mask_kind == "window" and window > 0:
            ok &= (qpos - kpos) < window
    lse = torch.logsumexp(torch.where(ok, sc, torch.full((), ref.NEG_INF)), -1, keepdim=True)
    p = torch.where(ok, torch.exp(sc - lse), torch.zeros(()))
    o = matmul(p, vh, terms)  # the forward's output
    d = (doh * o).sum(-1, keepdim=True)
    ds = p * (matmul(doh, vh.transpose(-1, -2).contiguous(), terms) - d) * dcap * scale

    def fresh_sum(a, bmat, n):  # sum over passes of n contraction rows, each product fresh
        out = torch.zeros(a.shape[:-1] + bmat.shape[-1:])
        for i in range(0, n, rows):
            out = out + matmul(a[..., i:i + rows].contiguous(), bmat[..., i:i + rows, :].contiguous(),
                               terms)
        return out

    dq = fresh_sum(ds, kh, t)
    dk = fresh_sum(ds.transpose(-1, -2), qh, s).reshape(b, nkv, g, t, hd)
    dv = fresh_sum(p.transpose(-1, -2), doh, s).reshape(b, nkv, g, t, hd)
    dk, dv = (x[:, :, 0] + sum(x[:, :, i] for i in range(1, g)) for x in (dk, dv))
    return dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _bwd_errors(case, terms):
    """Each gradient's max abs error as a share of BWD_TOL x its largest element."""
    q, k, v = _inputs(case, 0)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(q.shape).astype(np.float32))
    kw = dict(mask_kind=case[6], window=case[7], attn_softcap=case[8])
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    got = attention_bwd(q, k, v, do, terms=terms, **kw)
    return [float((g - w).abs().max()) / (BWD_TOL * float(w.abs().max())) for g, w in zip(got, want)]


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # of a TF32 number in [1, 2)
    x = np.array([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20, 1 + 3 * ulp / 2,
                  1 + ulp / 4, 3.0e38], dtype=np.float32)
    want = np.array([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0, 3.0e38], dtype=np.float64)
    got = tf32_rna(x)
    assert (got.view(np.uint32) & 0x1FFF == 0).all()  # 13 low bits clear
    np.testing.assert_array_equal(got[:-1].astype(np.float64), want[:-1])
    assert abs(float(got[-1]) / 3.0e38 - 1) < 2 ** -11


def test_split_carries_float32_precision():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    hi, lo = split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_3xtf32_attention_meets_float32_tolerance(case):
    """The split on the tensor cores is as close to the plain float32
    version as the reference's float32 tolerance asks."""
    q, k, v = _inputs(case, 0)
    kw = dict(mask_kind=case[6], window=case[7], attn_softcap=case[8])
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = attention(q, k, v, terms=3, **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_single_tf32_attention_misses_float32_tolerance(case):
    q, k, v = _inputs(case, 0)
    kw = dict(mask_kind=case[6], window=case[7], attn_softcap=case[8])
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = attention(q, k, v, terms=1, **kw)
    assert not torch.allclose(got, want, atol=TOL, rtol=TOL)
    assert float((got - want).abs().max()) > 20 * TOL


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_3xtf32_attention_bwd_meets_tolerance(case):
    """The backward's split, fresh per-pass sums and P from the lse keep each
    gradient within 1e-5 of its largest element of the plain version."""
    assert max(_bwd_errors(case, terms=3)) <= 1.0


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_single_tf32_attention_bwd_misses_tolerance(case):
    assert max(_bwd_errors(case, terms=1)) > 10.0
