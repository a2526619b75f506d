"""Spans and counters at the port's layer boundaries.

A span is a ``torch.profiler.record_function`` range: it lies on the
profiler's clock beside the CUDA device trace, and under
``torch.autograd.profiler.emit_nvtx`` it is also an NVTX range that nsys
shows.  There is no log and no clock of this module's own: the profiler
keeps the spans in memory and whoever drives it exports them (a Chrome
trace, ``key_averages``).

- ``span(name)``: a context manager around a block of host code;
  ``spanned(name)``, the same around every call of a function.
- ``call(name, fn, *args, **kwargs)``: ``fn(*args, **kwargs)`` inside the
  span ``name``; when autograd records the call, its backward pass lies in
  a span ``name + ".bwd"``.  Identity autograd marks make it: one node on
  the outputs opens the span when their gradients arrive, one on the
  inputs that need a gradient closes it when theirs leave, both on the
  autograd engine's thread.  A call none of whose inputs needs a gradient
  has no such span (nothing would close it).
- ``count(name, n)``, ``counts()``, ``reset(prefix)``: host integers
  derived from shapes (the kernels' launches under ``launch.<kernel>``,
  the MoE's rows, a checkpoint's bytes), counted whether or not a profiler
  records.

With no profiler recording, each helper reads the profiler's flag once and
runs its code directly: no range object, no autograd node, no host sync.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``name`` while a profiler records
    (``torch.profiler``, ``emit_nvtx``, ``emit_itt``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """A decorator: each call of the function lies in the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call_in_span(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call_in_span
    return wrap


class _Backward:
    """The ``.bwd`` range of one call."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def open(self):
        if self.rf is None:
            self.rf = torch.profiler.record_function(self.name).__enter__()
            # whatever happens after, the range ends with the backward pass
            torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def close(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _Open(torch.autograd.Function):
    """Identity on a call's outputs; its backward opens the range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.open()
        return (None, *grads)


class _Close(torch.autograd.Function):
    """Identity on a call's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.close()
        return (None, *grads)


def _leaves(tree, out: list):
    """The tensors in ``tree`` that need a gradient."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor) and tree.requires_grad:
        out.append(tree)
    return out


def _swap(tree, new: dict):
    """``tree`` with each tensor ``t`` whose id is in ``new`` replaced by ``new[id(t)]``."""
    if isinstance(tree, dict):
        return {k: _swap(v, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_swap(v, new) for v in tree)
    return new.get(id(tree), tree) if isinstance(tree, torch.Tensor) else tree


def _mark(fn_mark, rng, tree):
    xs = list({id(x): x for x in _leaves(tree, [])}.values())
    if not xs:
        return tree, False
    marked = fn_mark.apply(rng, *xs)
    return _swap(tree, {id(x): m for x, m in zip(xs, marked)}), True


def call(name: str, fn: Callable, *args, **kwargs) -> Any:
    """``fn(*args, **kwargs)`` inside the span ``name``, its backward pass
    inside ``name + ".bwd"`` (see the module's note).  Tensors are found in
    the arguments and the result through dicts, lists and tuples."""
    if not _profiler._is_profiler_enabled:
        return fn(*args, **kwargs)
    if not torch.is_grad_enabled():
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    rng = _Backward(name + ".bwd")
    (args, kwargs), marked = _mark(_Close, rng, (args, kwargs))
    with torch.profiler.record_function(name):
        out = fn(*args, **kwargs)
    if marked:
        out, _ = _mark(_Open, rng, out)
    return out


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_COUNTS: Dict[str, int] = {}
_LOCK = threading.Lock()  # the checkpoint's writer thread counts too


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """A copy of every counter that has counted since its reset."""
    with _LOCK:
        return dict(_COUNTS)


def reset(prefix: str = "") -> None:
    """Drop the counters whose names start with ``prefix`` (all by default)."""
    with _LOCK:
        for k in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[k]
