"""Logical-axis sharding layer (port of ``repro/parallel/sharding.py``).

Models annotate activations and params with *logical* axis names; a rule
table maps logical names to mesh axes.  Changing the parallelism strategy
means swapping the rule table (``parallel/strategies.py``), with no change
to model code.

Baseline strategy:
  * activations: batch -> ('pod', 'data'); sequence -> 'model'
    (2-D token sharding: every device owns a (batch/16 x seq/16) token tile)
  * weights + optimizer state: fully sharded (ZeRO-3/FSDP) over
    ('data', 'model') on the two largest dims, replicated over 'pod'
  * MoE experts: expert dim on 'model', falls back to FSDP inside
  * KV caches: batch -> 'data', cache sequence -> 'model'

A spec is a ``PartitionSpec``: one entry per tensor dim, each a mesh axis
name, a tuple of names, None (replicated) or ``UNCONSTRAINED``.  On a
``DeviceMesh`` a spec becomes DTensor placements (``placements``): mesh dim
*i* gets ``Shard(d)`` where tensor dim *d*'s entry names mesh axis *i*, else
``Replicate()``.  Every tuple entry must list its axes in mesh-dim order
(``("pod", "data")``, ``("data", "model")``), so that DTensor's row-major
split of one dim over several mesh dims is the spec's; ``placements``
asserts it.  ``shd`` is the only place where a spec moves data: on a
DTensor it redistributes to the resolved placements; on a plain tensor it
returns the tensor unchanged, so a model on one device runs as before.
"""
from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.parallel.compat import DeviceMesh, DTensor, Replicate, Shard

Axis = Optional[object]  # mesh axis name, tuple of names, None, or UNCONSTRAINED


class _Unconstrained:
    def __repr__(self) -> str:
        return "UNCONSTRAINED"


class PartitionSpec(tuple):
    """A tuple of per-dim mesh axes (the port's ``jax.sharding.PartitionSpec``)."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *axes: Axis):
        # a one-axis tuple is that axis, as in jax's PartitionSpec
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec
UNCONSTRAINED = PartitionSpec.UNCONSTRAINED


@dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axis (or tuple, or None=replicated)."""

    rules: Dict[str, Axis] = field(default_factory=dict)

    def get(self, name: Optional[str]) -> Axis:
        if name is None:
            return None
        return self.rules.get(name, None)

    def spec(self, *names: Optional[str]) -> P:
        return P(*(self.get(n) for n in names))

    def with_overrides(self, **kw: Axis) -> "AxisRules":
        d = dict(self.rules)
        d.update(kw)
        return AxisRules(d)


# Baseline rule table -------------------------------------------------------
DEFAULT_RULES = AxisRules(
    {
        # activations
        "batch": ("pod", "data"),
        "dp_batch": "data",  # batch sharding that must not touch 'pod'
        "seq": "model",
        "embed_act": None,  # activation feature dim
        "heads_act": None,
        "kv_seq": "model",  # KV-cache sequence dim (decode)
        "kv_long": ("data", "model"),  # long-context cache sequence (batch=1)
        "expert_act": "model",  # dispatched MoE token buffers
        "vocab_act": None,
        # params (FSDP: both biggest dims sharded; ZeRO-3 gathers per layer)
        "embed": "data",
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "conv": None,
        "state": None,
        "layers": None,  # stacked group dim, never sharded
    }
)

_tls = threading.local()


def set_rules(rules: AxisRules) -> None:
    _tls.rules = rules


def get_rules() -> AxisRules:
    return getattr(_tls, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def _mesh_axis_names() -> Tuple[str, ...]:
    """The mesh axes declared by ``force_mesh_axes``, or () outside one."""
    return getattr(_tls, "mesh_axes", None) or ()


@contextlib.contextmanager
def force_mesh_axes(names: Tuple[str, ...]):
    """Declare the mesh axes in effect for ``logical_spec`` (the dry-run
    and the tests, where no DTensor carries its mesh)."""
    prev = getattr(_tls, "mesh_axes", None)
    _tls.mesh_axes = tuple(names)
    try:
        yield
    finally:
        _tls.mesh_axes = prev


def _prune(axis: Axis, present: Tuple[str, ...]) -> Axis:
    """Drop mesh axes that don't exist in the active mesh (e.g. 'pod' on the
    single-pod mesh) so rule tables are mesh-shape agnostic."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in present)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in present else None


def _flat(a: Axis) -> Tuple[str, ...]:
    if a is None or a is UNCONSTRAINED:
        return ()
    return a if isinstance(a, tuple) else (a,)


def _dedupe(axes) -> P:
    """A mesh axis may appear at most once per spec: keep its first use."""
    seen, out = set(), []
    for a in axes:
        flat = _flat(a)
        if any(f in seen for f in flat):
            out.append(None)
            continue
        seen.update(flat)
        out.append(a)
    return P(*out)


def logical_spec(*names: Optional[str]) -> P:
    """PartitionSpec for the given logical axis names under current rules,
    pruned to the axes of ``force_mesh_axes``.  The sentinel '*' maps to
    ``UNCONSTRAINED`` (partial constraints)."""
    rules = get_rules()
    present = _mesh_axis_names()
    return _dedupe(UNCONSTRAINED if n == "*" else _prune(rules.get(n), present)
                   for n in names)


def _divisible(axis: Axis, dim: int, sizes) -> Axis:
    """Drop a sharding axis whose size does not divide the dim (shards must
    be even, e.g. vocab 49155 over 16); try the leading sub-tuple first."""
    if axis is None or not sizes:
        return axis
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    if n and dim % n == 0:
        return axis
    if isinstance(axis, tuple) and len(axis) > 1:
        return _divisible(axis[:-1], dim, sizes)
    return None


def mesh_names_sizes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names, {name: size}) of a ``DeviceMesh``, or of any object with
    ``axis_names`` and ``devices.shape`` (a shape-only stand-in)."""
    if isinstance(mesh, DeviceMesh):
        names = tuple(mesh.mesh_dim_names)
        return names, dict(zip(names, mesh.shape))
    names = tuple(mesh.axis_names)
    return names, dict(zip(names, mesh.devices.shape))


def resolve_spec(shape, names, present: Tuple[str, ...], sizes: Dict[str, int]) -> P:
    """``shd``'s spec for a tensor of ``shape`` annotated with ``names``:
    axes whose mesh size does not divide the dim (e.g. a size-1 decode seq
    dim) are dropped before duplicates are resolved, so later logical names
    (like 'mlp_act') can claim the mesh axis."""
    rules = get_rules()
    axes = []
    for n, dim in zip(names, shape):
        if n == "*":
            axes.append(UNCONSTRAINED)
            continue
        a = _prune(rules.get(n), present)
        if sizes:
            a = _divisible(a, dim, sizes)
        axes.append(a)
    axes += [None] * (len(shape) - len(axes))
    return _dedupe(axes)


def placements(spec, mesh: DeviceMesh, current=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim i is ``Shard(d)``
    where tensor dim d's entry names mesh axis i, else ``Replicate()``.  A
    mesh dim that shards an ``UNCONSTRAINED`` dim in ``current`` keeps it."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, a in enumerate(spec):
        flat = _flat(a)
        idx = [names.index(x) for x in flat]
        assert idx == sorted(idx), f"spec entry {a} is not in mesh-dim order {names}"
        for i in idx:
            out[i] = Shard(d)
    if current is not None:
        free = {d for d, a in enumerate(spec) if a is UNCONSTRAINED}
        for i, pl in enumerate(current):
            if isinstance(pl, Shard) and pl.dim in free:
                out[i] = pl
    return tuple(out)


def shd(x, *names: Optional[str]):
    """Sharding constraint by logical axis names.  On a DTensor: redistribute
    to the placements of ``resolve_spec`` on its mesh (a no-op when they
    already hold).  A plain tensor, which lies on one device, is returned
    unchanged."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    present, sizes = mesh_names_sizes(mesh)
    spec = resolve_spec(tuple(x.shape), names, present, sizes)
    want = placements(spec, mesh, current=x.placements)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def batch_axes() -> P:
    return logical_spec("batch")


# ---------------------------------------------------------------------------
# Parameter partition rules (by tree path)
# ---------------------------------------------------------------------------
# Params are nested dicts.  Rules are (regex over '/'-joined path) ->
# logical axis names per dimension.  First match wins.  Stacked groups have
# a leading dim which is handled automatically (rank mismatch pads with None
# at dim 0).

PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/table$", ("vocab", "embed")),
    (r"unembed/table$", ("embed", "vocab")),
    (r"pos_embed/table$", (None, "embed")),
    # attention
    (r"(attn|cross_attn)/wq$", ("embed", "heads", "head_dim")),
    (r"(attn|cross_attn)/wk$", ("embed", "kv_heads", "head_dim")),
    (r"(attn|cross_attn)/wv$", ("embed", "kv_heads", "head_dim")),
    (r"(attn|cross_attn)/wo$", ("heads", "head_dim", "embed")),
    (r"(attn|cross_attn)/bq$", ("heads", "head_dim")),
    (r"(attn|cross_attn)/b[kv]$", ("kv_heads", "head_dim")),
    (r"(attn|cross_attn)/(q_norm|k_norm)$", ("head_dim",)),
    # dense mlp
    (r"mlp/w(i|g)$", ("embed", "mlp")),
    (r"mlp/wo$", ("mlp", "embed")),
    # moe
    (r"moe/router$", ("embed", "expert")),
    (r"moe/w(i|g)$", ("expert", "embed", None)),
    (r"moe/wo$", ("expert", None, "embed")),
    # mamba
    (r"mamba/in_proj$", ("embed", "mlp")),
    (r"mamba/conv_w$", ("conv", "mlp")),
    (r"mamba/conv_b$", ("mlp",)),
    (r"mamba/x_proj$", ("mlp", None)),
    (r"mamba/dt_proj$", (None, "mlp")),
    (r"mamba/dt_bias$", ("mlp",)),
    (r"mamba/A_log$", ("mlp", "state")),
    (r"mamba/D$", ("mlp",)),
    (r"mamba/out_proj$", ("mlp", "embed")),
    # xlstm (mLSTM inner dim d_in uses 'mlp'; heads are few, unsharded)
    (r"mlstm/w_up$", ("embed", "mlp")),
    (r"mlstm/w(q|k|v)$", (None, "embed2", None)),
    (r"mlstm/w(i|f|o)$", ("mlp", None)),
    (r"mlstm/b(i|f|o)$", (None,)),
    (r"mlstm/skip$", ("mlp",)),
    (r"mlstm/w_down$", ("mlp", "embed")),
    (r"slstm/w(i|f|z|o)$", ("embed", "embed2")),
    (r"slstm/r(i|f|z|o)$", ("heads", "head_dim", "head_dim")),
    (r"slstm/b(i|f|z|o)$", ("embed2",)),
    (r"slstm/ffn_w(i|g)$", ("embed", "mlp")),
    (r"slstm/ffn_wo$", ("mlp", "embed")),
    # norms / scalars
    (r"(norm|norm1|norm2|norm3|final_norm|ln)/(scale|bias)$", ("embed",)),
    (r".*", ()),  # default: replicated
)

# 'embed2': second d_model-sized dim of the square sLSTM weights, sharded
# over 'model' to spread the 4 x d^2 matrices.
DEFAULT_RULES = DEFAULT_RULES.with_overrides(embed2="model")


def _spec_for_path(path: str, shape, rules: AxisRules, present, sizes) -> P:
    ndim = len(shape)
    for pattern, names in PARAM_RULES:
        if re.search(pattern, path):
            names_l = list(names)
            if len(names_l) < ndim:  # leading stacked group dims
                names_l = [None] * (ndim - len(names_l)) + names_l
            elif len(names_l) > ndim:
                names_l = names_l[-ndim:] if ndim else []
            axes = [_prune(rules.get(n), present) for n in names_l]
            return _dedupe(_divisible(a, d, sizes) for a, d in zip(axes, shape))
    return P(*([None] * ndim))


def param_pspecs(params, rules: Optional[AxisRules] = None, mesh=None):
    """A PartitionSpec tree for a param tree (leaves: tensors or anything
    with a ``shape``), over ``mesh``'s axes (a ``DeviceMesh`` or a
    shape-only stand-in) or, without one, those of ``force_mesh_axes``
    (default ('data', 'model'))."""
    rules = rules or get_rules()
    if mesh is not None:
        present, sizes = mesh_names_sizes(mesh)
    else:
        present, sizes = _mesh_axis_names() or ("data", "model"), {}

    def f(tree, path):
        if isinstance(tree, dict):
            return {k: f(v, path + (str(k),)) for k, v in tree.items()}
        return _spec_for_path("/".join(path), tuple(tree.shape), rules, present, sizes)

    return f(params, ())


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the DTensor placements of one leaf on it."""

    mesh: Any
    placements: tuple


def named_shardings(tree_pspecs, mesh: DeviceMesh):
    """A ``NamedSharding`` tree of a spec tree on ``mesh``."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return NamedSharding(mesh, placements(x, mesh))

    return conv(tree_pspecs)
