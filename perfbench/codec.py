"""A plain copy of the GRNCKPT1 checkpoint format's int8 codec.

A checkpoint file is ``b"GRNCKPT1"``, the manifest's length (8 bytes, little
endian), the manifest as JSON, then each leaf's bytes at its offset: raw
buffers, or for an int8 leaf the zlib-compressed int8 codes and then its
zlib-compressed float32 scales, one per group of 256 values.  A group's
scale is its largest magnitude over 127 (1 where it is 0), and a code is
round-half-even(x / scale) clamped to [-127, 127]; a value comes back as
code * scale, rounded to the leaf's type.

``quantize`` is the int8 rule in plain PyTorch; ``quantize_int4`` is the
same rule on 7 levels, the control of the exact comparison.
"""
from __future__ import annotations

import json
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

BLOCK = 256
MAGIC = b"GRNCKPT1"


def read(path: str) -> Tuple[dict, memoryview]:
    """(manifest, data) of a checkpoint file."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != MAGIC:
        raise ValueError(f"{path} is not a GRNCKPT1 checkpoint")
    n = int.from_bytes(raw[8:16], "little")
    return json.loads(raw[16:16 + n].decode()), memoryview(raw)[16 + n:]


def leaves(manifest: dict, data) -> Dict[str, dict]:
    """{path: entry} with, for int8 leaves, "codes" (int8) and "scales"
    (float32) numpy arrays, for raw leaves "raw" (bytes)."""
    out = {}
    for e in manifest["entries"]:
        chunk = data[e["offset"]: e["offset"] + e["nbytes"]]
        e = dict(e)
        if e["enc"] == "int8":
            e["codes"] = np.frombuffer(zlib.decompress(chunk[: e["qlen"]]), dtype=np.int8)
            e["scales"] = np.frombuffer(zlib.decompress(chunk[e["qlen"]:]), dtype=np.float32)
        else:
            e["raw"] = bytes(chunk)
        out[e["path"]] = e
    return out


def _groups(x: torch.Tensor) -> torch.Tensor:
    flat = x.detach().float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def quantize(x: torch.Tensor, levels: int = 127) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes (n_padded,) int8, scales (groups,) float32) of a leaf's float32
    values, padded with zeros to whole groups.  Divisions are tensor by
    tensor, so they are IEEE on the card too."""
    g = _groups(x)
    amax = g.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, float(levels)), torch.ones_like(amax))
    codes = torch.clamp(torch.round(g / scale[:, None]), -levels, levels).to(torch.int8)
    return codes.reshape(-1), scale


def quantize_int4(x: torch.Tensor):
    return quantize(x, levels=7)


def decode(entry: dict, device) -> torch.Tensor:
    """A leaf's values as the format defines them, on ``device``."""
    shape = tuple(entry["shape"])
    dtype = entry["dtype"]
    if entry["enc"] == "raw":
        if dtype == "bfloat16":
            words = np.frombuffer(entry["raw"], dtype=np.int16).copy()
            return torch.from_numpy(words).view(torch.bfloat16).reshape(shape).to(device)
        arr = np.frombuffer(entry["raw"], dtype=np.dtype(dtype)).copy()
        return torch.from_numpy(arr).reshape(shape).to(device)
    codes = torch.from_numpy(entry["codes"].copy()).to(device).float().reshape(-1, BLOCK)
    scales = torch.from_numpy(entry["scales"].copy()).to(device)
    flat = (codes * scales[:, None]).reshape(-1)
    n = int(np.prod(shape)) if shape else 1
    return flat[:n].reshape(shape).to(getattr(torch, dtype))
