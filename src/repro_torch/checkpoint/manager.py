"""Checkpoint manager (port of ``repro/checkpoint/manager.py``): periodic or
async saves, retention, restore onto a device -- the migration engine's
storage layer and the source of truth for the feasibility model's S_j.

Layout: <root>/<job>/step_<N>/checkpoint.bin  (manifest embedded).
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from repro_torch.checkpoint import serializer as ser
from repro_torch.convert import flatten_with_paths, params_to_numpy
from repro_torch.device import DeviceLike
from repro_torch.parallel.compat import distribute_tensor
from repro_torch.parallel.sharding import NamedSharding


@dataclass
class CheckpointInfo:
    job: str
    step: int
    path: str
    nbytes: int
    mode: str
    wall_time_s: float


class CheckpointManager:
    def __init__(
        self,
        root: str,
        job: str = "job0",
        *,
        mode: str = "full",
        keep: int = 3,
        async_save: bool = False,
    ):
        self.root = root
        self.job = job
        self.mode = mode
        self.keep = keep
        self.async_save = async_save
        self._history: List[CheckpointInfo] = []
        self._base_cache: Optional[Any] = None  # last saved host state (delta base)
        self._pending: Optional[threading.Thread] = None
        os.makedirs(self._job_dir(), exist_ok=True)
        self._scan_existing()

    # -- paths ---------------------------------------------------------------
    def _job_dir(self) -> str:
        return os.path.join(self.root, self.job)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._job_dir(), f"step_{step:08d}")

    def _scan_existing(self):
        for name in sorted(os.listdir(self._job_dir())):
            if name.startswith("step_"):
                p = os.path.join(self._job_dir(), name, "checkpoint.bin")
                if os.path.exists(p):
                    step = int(name.split("_")[1])
                    self._history.append(
                        CheckpointInfo(self.job, step, p, os.path.getsize(p), "?", 0.0))

    # -- API ------------------------------------------------------------------
    @property
    def latest(self) -> Optional[CheckpointInfo]:
        return self._history[-1] if self._history else None

    @property
    def latest_bytes(self) -> int:
        """S_j for the feasibility model — measured, not estimated."""
        self.wait()
        return self.latest.nbytes if self.latest else 0

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def save(self, step: int, state, *, mode: Optional[str] = None) -> CheckpointInfo:
        """Serialize and persist ``state`` (a tree of tensors or arrays).
        Quantization runs on the device the state lies on, on the caller's
        thread; with ``async_save`` only compression and IO run on the
        writer thread, which reads a state on the CPU in place: leave it
        unmodified until ``wait()``.  delta-int8 uses the previous save as
        base."""
        mode = mode or self.mode
        t0 = time.time()
        tensors = [x for _, x in flatten_with_paths(state) if isinstance(x, torch.Tensor)]
        device = tensors[0].device if tensors else "cpu"  # quantize where the state lies
        host_state = params_to_numpy(state)  # device -> host (gather)
        base = self._base_cache if mode == "delta-int8" else None
        if mode == "delta-int8" and base is None:
            mode = "int8"  # first checkpoint has no base
        encoded = ser.encode_tree(host_state, mode, base, device=device)

        def _write() -> CheckpointInfo:
            payload = ser.pack(encoded, mode)
            d = self._step_dir(step)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, "checkpoint.bin")
            with open(path, "wb") as f:
                ser.write_to(f, payload)
            return CheckpointInfo(self.job, step, path, os.path.getsize(path), mode, time.time() - t0)

        self.wait()
        if self.async_save:
            info = CheckpointInfo(self.job, step, "", 0, mode, 0.0)

            def run():
                done = _write()
                info.path, info.nbytes, info.wall_time_s = done.path, done.nbytes, done.wall_time_s

            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()
        else:
            info = _write()
        self._base_cache = host_state
        self._history.append(info)
        self._gc()
        return info

    def restore(
        self,
        like,
        *,
        step: Optional[int] = None,
        device: DeviceLike = None,
        base: Optional[Any] = None,
        shardings=None,
    ):
        """Load a checkpoint into the structure of ``like``, on ``device``
        (default: the card) -- how a migrated job resumes at its new site.
        With ``shardings`` (a tree like ``like``'s whose leaves are
        ``parallel.sharding.NamedSharding`` or None), each leaf is placed on
        that mesh with those placements, every rank keeping its shard of
        the same bytes: the elastic restore, by which a migrated job resumes
        on a differently shaped slice."""
        self.wait()
        infos = [i for i in self._history if step is None or i.step == step]
        if not infos:
            raise FileNotFoundError(f"no checkpoint for {self.job} step={step}")
        info = infos[-1]
        with open(info.path, "rb") as f:
            payload = ser.from_bytes(f.read())
        if payload.manifest["mode"] == "delta-int8" and base is None:
            base = self._base_cache
        tree = ser.deserialize_tree(payload, like, base=base, device=device)
        if shardings is not None:
            tree = _place(tree, shardings)
        return tree, info

    def _gc(self):
        while len(self._history) > self.keep:
            old = self._history.pop(0)
            shutil.rmtree(os.path.dirname(old.path), ignore_errors=True)

    # -- migration support -----------------------------------------------------
    def export_bytes(self, step: Optional[int] = None) -> bytes:
        self.wait()
        infos = [i for i in self._history if step is None or i.step == step]
        with open(infos[-1].path, "rb") as f:
            return f.read()

    @staticmethod
    def import_bytes(root: str, job: str, step: int, raw: bytes) -> "CheckpointManager":
        mgr = CheckpointManager(root, job)
        d = mgr._step_dir(step)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "checkpoint.bin")
        with open(path, "wb") as f:
            f.write(raw)
        mgr._history.append(CheckpointInfo(job, step, path, len(raw), "?", 0.0))
        return mgr


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings.get(k) if shardings is not None else None)
                for k, v in tree.items()}
    if isinstance(shardings, NamedSharding) and isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, shardings.mesh, shardings.placements, src_data_rank=None)
    return tree
