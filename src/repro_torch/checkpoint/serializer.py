"""Tree checkpoint serialization (GRNCKPT1) with exact byte accounting,
int8 compression and delta encoding; port of ``repro/checkpoint/serializer.py``.

The bytes match the JAX package's for the same tree: the same MAGIC,
manifest, BLOCK, leaf order and paths, zlib level 1, and int8 codes from
the quantize kernel, which is bit-identical to the JAX oracle.  So a
checkpoint written by either package restores in the other, and the
serialized size -- the feasibility model's S_j -- is the same number.

Modes:
  full        raw little-endian buffers as stored (a bfloat16 leaf's 16-bit
              words under "dtype": "bfloat16", as the JAX package writes it)
  int8        per-256-block symmetric int8 + f32 scales of the leaf's float32
              values (~4x smaller for f32, ~2x for bf16)
  delta-int8  int8-quantized (x - base) against a base the destination holds

Writing is two phases.  ``encode_tree`` runs the quantize kernel on
``device`` for every float leaf and brings the codes to the host;
``pack`` compresses and lays out the bytes, on the host only.  The
checkpoint manager runs ``pack`` on its writer thread, so no kernel is
launched off the caller's thread.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import (BF16, bf16_from_words, bf16_words_to_f32, flatten_with_paths,
                                 host_words, tree_map_with_path)
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops as kops

BLOCK = 256
MAGIC = b"GRNCKPT1"


def _path_str(path) -> str:
    return "/".join(path)


def _flatten(tree) -> List:
    """(path, host array, dtype name) per leaf; bfloat16 as its words."""
    return [(_path_str(p), *host_words(x)) for p, x in flatten_with_paths(tree)]


def _is_float(arr: np.ndarray, dtype: str) -> bool:
    return dtype == BF16 or np.issubdtype(arr.dtype, np.floating)


def _f32(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A float leaf's values in float32 (bfloat16 widens exactly)."""
    return bf16_words_to_f32(arr) if dtype == BF16 else arr.astype(np.float32)


def _torch_dtype(name: str) -> torch.dtype:
    if name == BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def tree_bytes(tree) -> int:
    """Exact raw (mode='full') checkpoint payload size in bytes."""
    return int(sum(x.size * x.dtype.itemsize for _, x, _ in _flatten(tree)))


@dataclass
class CheckpointPayload:
    manifest: Dict[str, Any]
    data: bytes  # or a memoryview of a checkpoint file's bytes (``from_bytes``)

    @property
    def nbytes(self) -> int:
        return len(self.data) + len(json.dumps(self.manifest).encode())


@dataclass
class EncodedLeaf:
    path: str
    shape: List[int]
    dtype: str
    raw: Optional[np.ndarray] = None  # mode 'full' or a non-float leaf: its C-order buffer
    q: Optional[bytes] = None  # int8 codes
    s: Optional[bytes] = None  # f32 scales
    pad: int = 0
    delta: bool = False


def _quant_flat(flat: np.ndarray, device: torch.device):
    """int8-quantize a flat f32 array (padded to BLOCK) on ``device``."""
    pad = (-flat.size) % BLOCK
    padded = np.pad(flat.astype(np.float32), (0, pad))
    q, s = kops.quantize_int8(torch.from_numpy(padded).to(device), block=BLOCK)
    return q.cpu().numpy().tobytes(), s.cpu().numpy().tobytes(), pad


def encode_tree(tree, mode: str = "full", base=None, *, device: DeviceLike = None) -> List[EncodedLeaf]:
    """Device phase: quantize every float leaf (int8 modes) on ``device``."""
    if mode not in ("full", "int8", "delta-int8"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "delta-int8" and base is None:
        raise ValueError("delta-int8 needs a base checkpoint tree")
    dev = resolve(device) if mode != "full" else None
    base_leaves = {p: (x, dt) for p, x, dt in _flatten(base)} if base is not None else {}
    out: List[EncodedLeaf] = []
    for path, arr, dtype in _flatten(tree):
        leaf = EncodedLeaf(path, list(arr.shape), dtype)
        if mode == "full" or not _is_float(arr, dtype):
            leaf.raw = np.ascontiguousarray(arr)  # the bytes tobytes() would give, uncopied
        else:
            flat = _f32(arr, dtype).reshape(-1)
            if mode == "delta-int8":
                b, b_dtype = base_leaves.get(path, (None, None))
                if b is not None and b.shape == arr.shape:
                    flat = flat - _f32(b, b_dtype).reshape(-1)
                    leaf.delta = True
            leaf.q, leaf.s, leaf.pad = _quant_flat(flat, dev)
        out.append(leaf)
    return out


def pack(leaves: List[EncodedLeaf], mode: str) -> CheckpointPayload:
    """Host phase: entropy-code the int8 codes and lay out the payload (the
    leaves' buffers joined once)."""
    entries: List[Dict[str, Any]] = []
    parts: List[Any] = []
    offset = 0
    for leaf in leaves:
        entry: Dict[str, Any] = {
            "path": leaf.path, "shape": leaf.shape, "dtype": leaf.dtype, "offset": offset,
        }
        if leaf.raw is not None:
            entry["enc"] = "raw"
            parts.append(leaf.raw)
            offset += leaf.raw.nbytes
        else:
            if leaf.delta:
                entry["delta"] = True
            # near-zero deltas collapse (the paper's §VIII compressed deltas)
            qz = zlib.compress(leaf.q, level=1)
            sz = zlib.compress(leaf.s, level=1)
            entry["enc"] = "int8"
            entry["pad"] = leaf.pad
            entry["qlen"] = len(qz)
            entry["q_raw"] = len(leaf.q)
            entry["s_raw"] = len(leaf.s)
            parts += [qz, sz]
            offset += len(qz) + len(sz)
        entry["nbytes"] = offset - entry["offset"]
        entries.append(entry)
    manifest = {"mode": mode, "block": BLOCK, "entries": entries}
    return CheckpointPayload(manifest, b"".join(parts))


def serialize_tree(tree, mode: str = "full", base=None, *, device: DeviceLike = None) -> CheckpointPayload:
    return pack(encode_tree(tree, mode, base, device=device), mode)


def deserialize_tree(payload: CheckpointPayload, like, base=None, *, device: DeviceLike = None):
    """Rebuild a tree with the structure of ``like`` on ``device``; int8
    leaves go through the dequantize kernel there and are rounded to their
    type as the JAX package's ``astype`` does (bfloat16: to nearest even).
    delta-int8 payloads need the same base tree."""
    dev = resolve(device)
    entries = {e["path"]: e for e in payload.manifest["entries"]}
    base_leaves = {p: (x, dt) for p, x, dt in _flatten(base)} if base is not None else {}
    data = payload.data
    block = payload.manifest["block"]

    def rebuild(path, _leaf):
        p = _path_str(path)
        e = entries[p]
        raw = data[e["offset"]: e["offset"] + e["nbytes"]]
        shape = tuple(e["shape"])
        if e["enc"] == "raw":
            if e["dtype"] == BF16:
                return bf16_from_words(np.frombuffer(raw, dtype=np.uint16).reshape(shape)).to(dev)
            arr = np.frombuffer(raw, dtype=np.dtype(e["dtype"])).reshape(shape)
            return torch.from_numpy(arr.copy()).to(dev)
        q = np.frombuffer(zlib.decompress(raw[: e["qlen"]]), dtype=np.int8)
        s = np.frombuffer(zlib.decompress(raw[e["qlen"]:]), dtype=np.float32)
        flat = kops.dequantize_int8(torch.from_numpy(q.copy()).to(dev),
                                    torch.from_numpy(s.copy()).to(dev), block=block)
        if e["pad"]:
            flat = flat[: -e["pad"]]
        if e.get("delta") and p in base_leaves:
            flat = flat + torch.from_numpy(_f32(*base_leaves[p]).reshape(-1)).to(dev)
        return flat.reshape(shape).to(_torch_dtype(e["dtype"]))

    return tree_map_with_path(rebuild, like)


def _header(payload: CheckpointPayload) -> bytes:
    mjson = json.dumps(payload.manifest).encode()
    return MAGIC + len(mjson).to_bytes(8, "little") + mjson


def to_bytes(payload: CheckpointPayload) -> bytes:
    return _header(payload) + payload.data


def write_to(f, payload: CheckpointPayload) -> None:
    """Write ``to_bytes(payload)`` to the binary file ``f`` without joining
    the header and the payload in memory first."""
    f.write(_header(payload))
    f.write(payload.data)


def from_bytes(raw: bytes) -> CheckpointPayload:
    """The payload of a checkpoint's bytes; its data is a view of ``raw``."""
    if raw[:8] != MAGIC:
        raise ValueError("not a GRNCKPT1 checkpoint")
    mlen = int.from_bytes(raw[8:16], "little")
    manifest = json.loads(bytes(raw[16: 16 + mlen]).decode())
    return CheckpointPayload(manifest, memoryview(raw)[16 + mlen:])
