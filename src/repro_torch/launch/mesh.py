"""Device meshes (port of ``repro/launch/mesh.py``).

Functions, not module constants: importing this module initializes no
process group and touches no device.

* ``make_mesh(shape, axes, device_type)``: a ``DeviceMesh`` over the
  process group already initialized (its world size is the mesh's size).
* ``make_production_mesh(multi_pod=)``: the TPU pod meshes the JAX package
  lowers against, (16, 16) ('data', 'model') or (2, 16, 16) ('pod', 'data',
  'model'), over a *fake* world of 256 or 512 ranks in this process
  (``init_process_group("fake")``): collectives move nothing, which is what
  the compile-only dry-run needs.  The fake world is process-global, so a
  process makes at most one (``launch/dryrun.py`` lowers a cell in its own
  process).
* ``make_local_mesh()``: a real 1 x 1 ('data', 'model') mesh over a one-rank
  process group on this machine (a ``FileStore`` under ``build/``, no
  network): every shard is the whole tensor, so a DTensor program runs the
  same kernels as the unsharded one.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch.distributed as dist

from repro_torch.kernels._build import BUILD_DIR
from repro_torch.parallel.compat import DeviceMesh, fake_store, init_device_mesh

__all__ = ["make_local_mesh", "make_mesh", "make_production_mesh"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the initialized world."""
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=fake_store(), rank=0, world_size=world)
    elif dist.get_backend() != "fake":
        raise RuntimeError("the production mesh needs a fake world; this process already "
                           f"has a {dist.get_backend()} process group")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The 1 x 1 mesh with the production axis names, over a one-rank
    process group (initialized here unless one is)."""
    if not dist.is_initialized():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"local_mesh_store_{os.getpid()}"
        if path.exists():
            path.unlink()
        dist.init_process_group(_BACKENDS[device_type], store=dist.FileStore(str(path), 1),
                                rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device_type)
