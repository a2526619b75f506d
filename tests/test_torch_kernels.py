"""The port's kernels on the CPU: the plain PyTorch versions against the JAX
package's oracles (and one Pallas interpret run), on numpy inputs made from
a seed.  The CUDA kernels themselves run only on the card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.grouped_gemm import (
    grouped_mlp_bwd_cuda, grouped_mlp_cuda, moe_combine_bwd_cuda, moe_rows_sum_cuda)
from repro_torch.kernels.quantize import dequantize_int8_cuda, quantize_int8_cuda
from test_kernels import SWEEP

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _qkv(seed, b, s, t, nh, nkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd)))


def _both(arrays, jdtype):
    """The same values as jax arrays and torch tensors of the row's dtype
    (bf16 rounds to nearest even from f32 in both frameworks)."""
    return ([jnp.asarray(a).astype(jdtype) for a in arrays],
            [torch.from_numpy(a).to(TORCH_DTYPE[jdtype]) for a in arrays])


@pytest.mark.parametrize("s,t,nh,nkv,hd,mask,win,cap,dtype,tol", SWEEP)
def test_flash_plain_matches_jax_oracle(s, t, nh, nkv, hd, mask, win, cap, dtype, tol):
    """Every SWEEP row of tests/test_kernels.py at the reference's own
    tolerance: 2e-6 for f32, 2e-2 for bf16."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, 2, s, t, nh, nkv, hd), dtype)
    want = jref.flash_attention_ref(jq, jk, jv, mask_kind=mask, window=win, attn_softcap=cap)
    got = ops.flash_attention(tq, tk, tv, mask_kind=mask, window=win, attn_softcap=cap)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_plain_matches_pallas_interpret():
    """The plain version against the Pallas kernel body itself (interpret
    mode), on the first SWEEP row, at 2e-6."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 128, 128, 4, 4, 64), jnp.float32)
    want = flash_attention_pallas(jq, jk, jv, mask_kind="causal", interpret=True)
    got = ref.flash_attention_ref(tq, tk, tv, mask_kind="causal")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=2e-6)


def _quant_cases():
    rng = np.random.default_rng(3)
    ties = (np.arange(256) % 254 - 127).astype(np.float32) + 0.5
    ties[0] = 127.0  # amax 127 -> scale exactly 1.0 -> every other code is a .5 tie
    return {
        "f32": (rng.standard_normal(256 * 64) * 3).astype(np.float32),
        "f32-large": (rng.standard_normal(256 * 64 * 4) * 3).astype(np.float32),
        "zero-block": np.concatenate([np.zeros(256, np.float32),
                                      rng.standard_normal(256).astype(np.float32)]),
        "ties": ties,
        "rows-1": rng.standard_normal(256).astype(np.float32),
        "rows-3": (rng.standard_normal(256 * 3) * 100).astype(np.float32),
        "rows-100": (rng.standard_normal(256 * 100) * 1e-3).astype(np.float32),
        "rows-1001": rng.standard_normal(256 * 1001).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(_quant_cases()))
def test_quantize_plain_bit_exact(case):
    x = _quant_cases()[case]
    q_j, s_j = jref.quantize_int8_ref(jnp.asarray(x))
    q_t, s_t = ops.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    if case == "ties":
        assert (np.abs(x[1:]) % 1 == 0.5).all()
        np.testing.assert_array_equal(q_t.numpy(), np.round(x))  # half to even
    d_j = jref.dequantize_int8_ref(q_j, s_j)
    d_t = ops.dequantize_int8(q_t, s_t)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_quantize_plain_bf16_input_bit_exact():
    x = (np.random.default_rng(4).standard_normal(256 * 128) * 3).astype(np.float32)
    q_j, s_j = jref.quantize_int8_ref(jnp.asarray(x).astype(jnp.bfloat16))
    q_t, s_t = ops.quantize_int8(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_ops_on_cpu_take_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 64, 64, 2, 2, 32))
    got = ops.flash_attention(q, k, v, mask_kind="causal")
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, mask_kind="causal"))
    x = torch.from_numpy(_quant_cases()["rows-3"])
    qv, sv = ops.quantize_int8(x)
    ops.dequantize_int8(qv, sv)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bf16": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_bf16": 0,
                                   "quantize_int8": 0, "dequantize_int8": 0, "decide_dest": 0,
                                   "grouped_gemm": 0, "moe_rows": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_cuda(qb, qb, qb)
    with pytest.raises(ValueError):
        quantize_int8_cuda(torch.zeros(256))
    with pytest.raises(ValueError):
        dequantize_int8_cuda(torch.zeros(256, dtype=torch.int8), torch.ones(1))
    rows, w, offsets = torch.zeros(8, 16), torch.zeros(2, 16, 8), torch.tensor([0, 4, 8])
    with pytest.raises(ValueError):
        grouped_mlp_cuda(rows, w, w, w.transpose(1, 2).contiguous(), offsets, num_experts=2)
    with pytest.raises(ValueError):
        grouped_mlp_bwd_cuda(rows, rows, torch.zeros(8, 16), torch.zeros(8, 8), w, w,
                             w.transpose(1, 2).contiguous(), offsets, num_experts=2)
    inv, gates = torch.arange(8), torch.full((4, 2), 0.5)
    with pytest.raises(ValueError):
        moe_rows_sum_cuda(rows, inv, gates, 2)
    with pytest.raises(ValueError):
        moe_combine_bwd_cuda(rows, torch.zeros(4, 16), inv, gates)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bf16": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_bf16": 0,
                                   "quantize_int8": 0, "dequantize_int8": 0, "decide_dest": 0,
                                   "grouped_gemm": 0, "moe_rows": 0}

