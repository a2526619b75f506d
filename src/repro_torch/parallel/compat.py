"""PyTorch version shims, consolidated in one place (the port's counterpart
of the JAX package's ``parallel/compat.py``).

This is the one module that names imports whose path depends on the torch
version: the DTensor module (public since torch 2.4), ``init_device_mesh``,
the flag behind ``implicit_replication`` (a private attribute of DTensor's
dispatcher) and the fake process-group store, which lives in torch's
internal testing package.  An import that fails raises ImportError here;
nothing degrades to another behaviour.  Importing this module initializes no process group.
"""
from __future__ import annotations

import contextlib

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh  # noqa: F401
from torch.distributed.tensor import (  # noqa: F401
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)


@contextlib.contextmanager
def implicit_replication():
    """Plain tensors count as replicated DTensors inside (torch's
    ``implicit_replication``, which resets the flag to off when it exits,
    so it cannot nest; this one restores the flag it found)."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def fake_store():
    """A ``FakeStore`` for ``init_process_group("fake", ...)``: a world of
    any size in one process, whose collectives move nothing (the dry-run's
    production mesh).  The module is torch-internal, so it is imported only
    when a fake world is made."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


__all__ = [
    "DTensor", "DeviceMesh", "Partial", "Replicate", "Shard",
    "distribute_tensor", "fake_store", "implicit_replication", "init_device_mesh",
]
