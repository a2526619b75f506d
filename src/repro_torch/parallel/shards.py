"""Running a region of the model on local shards of DTensors.

DTensor propagates shardings op by op.  Some regions are better run on each
rank's shard with plain tensor code: a recurrent scan along the sequence
(Mamba, mLSTM, sLSTM), MoE routing (top-k along the expert dim of each
token) and the attention kernel, whose math must be local.  Each of them is
local in the batch (and, for routing, in the sequence): ``on_shards``
redistributes its activation so that only those dims stay sharded, gathers
the params it reads (the per-layer ZeRO-3 gather of the FSDP rules), runs
the plain code on the local tensors and wraps the result with the
activation's placements.  On plain tensors every helper is the identity, so
a model on one device runs exactly as before.
"""
from __future__ import annotations

import contextlib
import operator
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.parallel.compat import DTensor, Partial, Replicate, Shard, implicit_replication


def keep_only(x, dims: Sequence[int]):
    """``x`` redistributed so that only its tensor dims ``dims`` stay
    sharded: every other Shard (and any Partial) becomes Replicate."""
    want = tuple(pl if isinstance(pl, Shard) and pl.dim in dims else Replicate()
                 for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _partial_where_split(ref) -> Optional[tuple]:
    """Gradient placements of a whole value used with ``ref``'s shards: a
    partial sum over the mesh dims that split ``ref`` (each rank's gradient
    comes from its own shard), replicated over the others."""
    if ref is None:
        return None
    return tuple(Partial() if isinstance(pl, Shard) else Replicate() for pl in ref.placements)


def full_local(tree, ref: Optional[DTensor] = None):
    """Every DTensor leaf of a tree (dicts, tuples, lists) as its whole
    value on this rank (gathered), every other leaf as it is.  With ``ref``
    (the activation the values meet), their gradients are summed over the
    mesh dims that split ``ref``."""
    if isinstance(tree, dict):
        return {k: full_local(v, ref) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full_local(v, ref) for v in tree)
    if isinstance(tree, DTensor):
        return keep_only(tree, ()).to_local(grad_placements=_partial_where_split(ref))
    return tree


def wrap_like(local: torch.Tensor, ref: DTensor):
    """A DTensor of ``local`` shards with ``ref``'s mesh and placements
    (shards even, so the global shape follows from the local one)."""
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False)


def replicated(local: torch.Tensor, mesh):
    """A value every rank holds whole, as a replicated DTensor (so that the
    gradient it receives from DTensor code comes back as a plain tensor)."""
    return DTensor.from_local(local, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def shard_mean(local_mean: torch.Tensor, ref: DTensor, dims: Sequence[int]) -> torch.Tensor:
    """The mean over all shards of a per-shard mean taken over ``ref``'s
    tensor dims ``dims`` (even shards): a replicated plain tensor.  With one
    shard it is ``local_mean`` itself."""
    mesh = ref.device_mesh
    split = [i for i, pl in enumerate(ref.placements) if isinstance(pl, Shard) and pl.dim in dims]
    n = 1
    for i in split:
        n *= mesh.size(i)
    if n == 1:
        return local_mean
    # a sum, then / n: DTensor's backward of a reduction passes the gradient
    # through unscaled, right for a sum and not for an average
    parts = tuple(Partial() if i in split else Replicate() for i in range(mesh.ndim))
    out = DTensor.from_local(local_mean, mesh, parts, run_check=False)
    return out.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local() / n


def _placed_like(tree, ref: DTensor):
    """Every DTensor leaf of ``tree`` redistributed to ``ref``'s placements
    (leaves whose dim 0 is the batch, as ``ref``'s is), as local tensors."""
    if isinstance(tree, dict):
        return {k: _placed_like(v, ref) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        want = tuple(ref.placements)
        return (tree if tuple(tree.placements) == want
                else tree.redistribute(ref.device_mesh, want)).to_local()
    return tree


def on_shards(fn: Callable[..., Any], x, *rest, keep: Sequence[int] = (0,),
              batched: Sequence[int] = ()):
    """``fn(x, *rest)`` on local shards: ``x`` keeps only the tensor dims
    ``keep`` sharded; the arguments of ``rest`` at positions ``batched``
    (recurrent states, batch first) are placed as ``x``, every other DTensor
    in ``rest`` is gathered whole; each tensor ``fn`` returns (or each leaf
    of a returned dict or tuple) is wrapped with ``x``'s placements: it must
    be sharded where x is (batch first).  On a plain ``x`` it is
    ``fn(x, *rest)``."""
    if not isinstance(x, DTensor):
        return fn(x, *rest)
    xs = keep_only(x, keep)
    args = [_placed_like(a, xs) if i in batched else full_local(a, xs) for i, a in enumerate(rest)]
    out = fn(xs.to_local(), *args)

    def wrap(o):
        if isinstance(o, dict):
            return {k: wrap(v) for k, v in o.items()}
        if isinstance(o, tuple):
            return tuple(wrap(v) for v in o)
        if isinstance(o, torch.Tensor):
            return wrap_like(o, xs)
        return o

    return wrap(out)


def _as_dtensor(t, mesh):
    return t if isinstance(t, DTensor) else replicated(t, mesh)


def einsum(eq: str, x, w, local_op: Optional[Callable] = None):
    """``torch.einsum(eq, x, w)`` for an activation ``x`` and a weight
    ``w``.  On DTensors it runs locally, mesh dim by mesh dim: x keeps a
    shard of a label the output keeps (the batch, the sequence); w keeps a
    shard of an output label x does not split (tensor-parallel columns) or
    of a label x splits the same way; a label both split and the product
    sums over gives a partial sum (row-parallel); every other shard is
    gathered (the ZeRO-3 gather of an FSDP weight).  DTensor's own einsum
    would flatten a (batch, sequence) pair sharded over two mesh dims into
    a strided shard its matmul strategies do not take.  ``local_op`` (default
    ``torch.einsum(eq, ...)``) computes the local product: ``matmul`` passes
    ``@``, so that one shard gives the unsharded product's bits."""
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return torch.einsum(eq, x, w)
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    ins, out = eq.split("->")
    lx, lw = ins.split(",")
    px, pw, po = [], [], []
    gx, gw = [], []  # the local operands' gradient placements
    for a, b in zip(x.placements, w.placements):
        la = lx[a.dim] if isinstance(a, Shard) else None
        lb = lw[b.dim] if isinstance(b, Shard) else None
        if la is not None and la not in out:  # x split on a summed label
            if lb == la:
                px.append(a), pw.append(b), po.append(Partial())
                gx.append(a), gw.append(b)
                continue
            la = None
        if la is not None:  # x split on a kept label
            pb = Shard(lw.index(la)) if la in lw else Replicate()  # a label both have: w's chunk
            px.append(a), pw.append(pb), po.append(Shard(out.index(la)))
            gx.append(a), gw.append(pb if la in lw else Partial())
        elif lb is not None and lb in out:  # w split on a kept label
            pa = Shard(lx.index(lb)) if lb in lx else Replicate()
            px.append(pa), pw.append(b), po.append(Shard(out.index(lb)))
            gx.append(pa if lb in lx else Partial()), gw.append(b)
        else:
            px.append(Replicate()), pw.append(Replicate()), po.append(Replicate())
            gx.append(Replicate()), gw.append(Replicate())
    xs = x if tuple(x.placements) == tuple(px) else x.redistribute(mesh, px)
    ws = w if tuple(w.placements) == tuple(pw) else w.redistribute(mesh, pw)
    xl, wl = xs.to_local(grad_placements=gx), ws.to_local(grad_placements=gw)
    local = local_op(xl, wl) if local_op is not None else torch.einsum(eq, xl, wl)
    return DTensor.from_local(local, mesh, po, run_check=False)


_LABELS = "abcdefghijklmnopqrstuvw"


def matmul(x, w):
    """``x @ w`` for an activation (..., k) and a 2-d weight (k, n);
    on DTensors, ``einsum`` of the same product."""
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return x @ w
    lead = _LABELS[:x.dim() - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w, operator.matmul)


def take_rows(table, idx):
    """``table[idx]`` (an embedding lookup); on DTensors, each rank looks up
    its shard of the ids in the whole table (gathered), and the rows take
    the ids' placements."""
    if not (isinstance(table, DTensor) or isinstance(idx, DTensor)):
        return table[idx]
    if not isinstance(idx, DTensor):
        return replicated(full_local(table)[idx], table.device_mesh)
    idx = keep_only(idx, range(idx.dim()))
    return DTensor.from_local(full_local(table, idx)[idx.to_local()], idx.device_mesh,
                              idx.placements, run_check=False)


@contextlib.contextmanager
def mesh_scope(tree, *, inference: bool = False):
    """``implicit_replication()`` when ``tree`` holds a DTensor (plain
    tensors made inside the model, such as positions, masks and rope tables,
    then count as replicated).  With ``inference``, also no autograd:
    ``torch.inference_mode()`` on plain tensors, ``torch.no_grad()`` on
    DTensors (whose views of tensors made outside inference mode it
    refuses).  A tree is placed whole, so its first leaf tells."""
    sharded = isinstance(next(_leaves(tree), None), DTensor)
    with contextlib.ExitStack() as stack:
        if sharded:
            stack.enter_context(implicit_replication())
        if inference:
            stack.enter_context(torch.no_grad() if sharded else torch.inference_mode())
        yield


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
