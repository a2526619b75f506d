"""Rotary position embeddings: standard RoPE and qwen2-vl's M-RoPE (port
of ``repro/models/rope.py``)."""
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


def apply_mrope(
    x: torch.Tensor,  # (b, s, h, head_dim)
    positions: torch.Tensor,  # (b, s, 3) int: temporal / height / width ids
    theta: float,
    sections,  # half-dim split, e.g. (16, 24, 24)
) -> torch.Tensor:
    """qwen2-vl multimodal RoPE: the rotary half-dim is partitioned into
    ``sections``, each rotated by its own position stream (t / h / w)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to the half-dim {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    section_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))  # (half,)
    pos = positions.float()[..., section_id]  # (b, s, half): each column's stream
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_positional(x, positions, rope_type: str, theta: float, sections=()):
    if rope_type == "none":
        return x
    if rope_type == "mrope":
        if positions.dim() == 2:  # text-only fallback: the same stream thrice
            positions = torch.stack([positions] * 3, dim=-1)
        return apply_mrope(x, positions, theta, sections)
    if positions.dim() == 3:
        positions = positions[..., 0]
    return apply_rope(x, positions, theta)
