"""Rotary position embeddings (port of ``repro/models/rope.py``).

Standard RoPE only; qwen2-vl's M-RoPE comes with that architecture
(ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, f32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(
    x: torch.Tensor,  # (b, s, h, head_dim)
    positions: torch.Tensor,  # (b, s) int
    theta: float,
) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions.float()[..., None] * freqs  # (b, s, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_positional(x, positions, rope_type: str, theta: float, sections=()):
    if rope_type == "none":
        return x
    if rope_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP Queue 1, item 10)")
    if positions.dim() == 3:
        positions = positions[..., 0]
    return apply_rope(x, positions, theta)
