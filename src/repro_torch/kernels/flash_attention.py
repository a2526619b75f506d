"""Flash attention forward on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces ``flash_attention_pallas`` (``repro/kernels/flash_attention.py``).
The plain version is ``kernels/ref.py::flash_attention_ref``.  q, k and v
are all float32 (tensor cores in 3xTF32, float32-class accuracy) or all
bfloat16 (float32 accumulation, output in bfloat16); any other type
raises.  The wrapper counts its launches per type: float32 in
``flash_attention_cuda.launches``, bfloat16 in
``flash_attention_cuda.launches_bf16``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
MASK_KINDS = {"full": 0, "causal": 1, "window": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(
    q: torch.Tensor,  # (b, s, nh, hd)
    k: torch.Tensor,  # (b, t, nkv, hd)
    v: torch.Tensor,  # (b, t, nkv, hd)
    *,
    mask_kind: str = "causal",
    window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {x.device}")
        if x.dtype != q.dtype or x.dtype not in DTYPES:
            raise ValueError(f"q, k and v must all be float32 or all bfloat16; {name} is {x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got {tuple(x.shape)}")
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if nkv == 0 or nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of num_kv_heads {nkv}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"mask_kind {mask_kind!r} not in {sorted(MASK_KINDS)}")
    o = torch.empty_like(q)
    lib = _build.load()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, s, t, nh, nkv, hd, MASK_KINDS[mask_kind], int(window),
        float(attn_softcap), hd ** -0.5, DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    if q.dtype == torch.bfloat16:
        flash_attention_cuda.launches_bf16 += 1
    else:
        flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_bf16 = 0
