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
    """``fn(x, *rest)`` on local shards, for regions with no channel axis
    (the sLSTM, MoE routing, attention): ``x`` keeps only the tensor dims
    ``keep`` sharded; the arguments of ``rest`` at positions ``batched``
    (recurrent states, batch first) are placed as ``x``, every other DTensor
    in ``rest`` is gathered whole; each tensor ``fn`` returns (or each leaf
    of a returned dict or tuple) is wrapped with ``x``'s placements: it must
    be sharded where x is (batch first).  On a plain ``x`` it is
    ``fn(x, *rest)``.  Mamba and the mLSTM run on channel shards instead
    (``on_channel_shards``)."""
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


class Whole:
    """The channel view of a region that runs on whole tensors: one block
    of every channel; ``reduce`` and ``gather`` are the identity."""

    index, count = 0, 1

    @staticmethod
    def reduce(t):
        return t

    @staticmethod
    def gather(t):
        return t


class ChannelShards:
    """A region's view of its rank's block: the batch shard over the mesh
    dims ``batch``, the ``index``-th of ``count`` equal channel blocks over
    the mesh dims ``chan`` (row-major, as DTensor splits one tensor dim over
    several mesh dims)."""

    def __init__(self, mesh, batch: Sequence[int], chan: Sequence[int]):
        self.mesh, self.batch, self.chan = mesh, tuple(batch), tuple(chan)
        coord = mesh.get_coordinate()
        self.index, self.count = 0, 1
        for i in self.chan:
            self.index = self.index * mesh.size(i) + coord[i]
            self.count *= mesh.size(i)

    def placed(self, dim: Optional[int], other=Replicate()) -> tuple:
        """Placements of a block: the batch (dim 0) split over ``batch``,
        tensor dim ``dim`` over ``chan`` (``other`` there if ``dim`` is
        None), every other mesh dim ``Replicate()``."""
        return tuple(Shard(0) if i in self.batch else
                     (Shard(dim) if dim is not None else other) if i in self.chan else
                     Replicate() for i in range(self.mesh.ndim))

    def grads(self, dim: Optional[int]) -> tuple:
        """Gradient placements of a weight used on this block: its shard
        along ``dim`` over ``chan`` (a partial sum there if ``dim`` is None:
        every block used the whole weight), a partial sum over ``batch``."""
        return tuple(Partial() if i in self.batch else
                     (Shard(dim) if dim is not None else Partial()) if i in self.chan else
                     Replicate() for i in range(self.mesh.ndim))

    def local(self, w, dim: Optional[int]):
        """A weight's local block: its shard along ``dim`` over ``chan``,
        whole along every other dim (the ZeRO-3 gather); all of it if
        ``dim`` is None."""
        if not isinstance(w, DTensor):
            return w
        want = tuple(Shard(dim) if i in self.chan and dim is not None else Replicate()
                     for i in range(self.mesh.ndim))
        ws = w if tuple(w.placements) == want else w.redistribute(self.mesh, want)
        return ws.to_local(grad_placements=self.grads(dim))

    def columns(self, w, parts: int):
        """The columns of ``w`` (k, parts * n) that this block reads when
        its product is cut into ``parts`` equal parts, each split over
        ``chan``: this rank's block of every part, side by side (all of
        ``w`` with one block)."""
        wl = self.local(w, None)
        if self.count == 1:
            return wl
        n = wl.shape[-1] // parts
        c = n // self.count
        return torch.cat([wl[..., k * n + self.index * c: k * n + (self.index + 1) * c]
                          for k in range(parts)], dim=-1)

    def state(self, t, dim: Optional[int]):
        """A state leaf (batch first) as this block's local tensor, its
        channel dim ``dim`` split over ``chan``."""
        want = self.placed(dim)
        ts = t if tuple(t.placements) == want else t.redistribute(self.mesh, want)
        return ts.to_local(grad_placements=want)

    def wrap(self, t, dim: Optional[int], other=Replicate()):
        return DTensor.from_local(t, self.mesh, self.placed(dim, other), run_check=False)

    def reduce(self, t):
        """The sum over the channel blocks of a partial sum (batch first)."""
        if self.count == 1:
            return t
        part = DTensor.from_local(t, self.mesh, self.placed(None, Partial()), run_check=False)
        return part.redistribute(self.mesh, self.placed(None)).to_local()

    def gather(self, t):
        """A block of channels (the last dim) as all of them (the block
        itself when there is one: its gradient then sums in the order of
        the unsharded code's)."""
        if self.count == 1:
            return t
        block = DTensor.from_local(t, self.mesh, self.placed(t.dim() - 1), run_check=False)
        return block.redistribute(self.mesh, self.placed(None)).to_local(
            grad_placements=self.placed(None, Partial()))


def on_channel_shards(fn: Callable[..., Any], x, params: dict, channels: dict,
                      state: Optional[dict] = None, state_channels: Optional[dict] = None):
    """``fn(x, params, ch, state)`` on each rank's batch shard and its
    block of a recurrent mixer's inner channels (a ``ChannelShards``
    ``ch``), the sequence whole.  Without a state (a full sequence) the
    blocks are where the params' rules put the inner channels: over the
    mesh dims that split ``params[first key of channels]`` along it, and
    x's batch stays split as it is.  With a state (recurrent states, batch
    first, placed by their pspecs), both follow the state, which never
    moves: the blocks are where its leaf ``first key of state_channels``
    splits its channel dim (none under the baseline rules, whose decode
    states are whole over 'model'), and x's batch is split as the state's.
    ``channels`` gives each param's channel dim: an int (its block stays
    local), ``("cols", k)`` (a weight whose product is cut into k parts,
    each split into blocks: ``ChannelShards.columns``) or None (gathered
    whole); params it does not name are gathered whole.  ``state_channels``
    gives each state leaf's channel dim (None: whole).  ``fn`` returns (its
    block's part of a sum (b, s, d) over the blocks, the new state or
    None); the part comes back as a DTensor, partial over the blocks'
    mesh dims, the state with the blocks' placements.  On a plain ``x``
    every tensor is whole: ``fn(x, params, Whole, state)``."""
    if not isinstance(x, DTensor):
        return fn(x, params, Whole, state)
    mesh = x.device_mesh
    if state:
        name, sdim = next(iter(state_channels.items()))
        lead = state[name].placements
        batch = [i for i, pl in enumerate(lead) if pl == Shard(0)]
        chan = [i for i, pl in enumerate(lead) if pl == Shard(sdim)]
    else:
        batch = [i for i, pl in enumerate(x.placements) if pl == Shard(0)]
        name, how = next(iter(channels.items()))
        cdim = (params[name].dim() - 1) if isinstance(how, tuple) else how
        chan = [i for i, pl in enumerate(params[name].placements)
                if pl == Shard(cdim) and i not in batch]
    ch = ChannelShards(mesh, batch, chan)
    xb = x.redistribute(mesh, ch.placed(None))
    local = {}
    for k, w in params.items():
        how = channels.get(k)
        local[k] = ch.columns(w, how[1]) if isinstance(how, tuple) else ch.local(w, how)
    st = None if state is None else {k: ch.state(t, state_channels.get(k))
                                     for k, t in state.items()}
    # every block reads all of x: its gradient is a partial sum over them
    out, new = fn(xb.to_local(grad_placements=ch.placed(None, Partial())), local, ch, st)
    out = ch.wrap(out, None, Partial())
    if new is not None:
        new = {k: ch.wrap(t, state_channels.get(k)) for k, t in new.items()}
    return out, new


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
