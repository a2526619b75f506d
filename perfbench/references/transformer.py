"""Plain PyTorch reference of a decoder-only transformer trained with AdamW.

It covers the benchmark's transformer configurations: token embedding,
RMSNorm, rotary positions, causal grouped-query attention, a SwiGLU MLP or a
top-k mixture of experts with its load-balance loss, the tied (or separate)
output head, mean cross entropy, global-norm clipping and AdamW with a float32
master copy.  Every product is a float32 ``torch.matmul`` with TF32 off, unless
``precision`` asks for the emulated lower precision that serves as the
control ("tf32": operands rounded to 10 mantissa bits; "fp8": operands scaled
per tensor into float8 e4m3, gradients into e5m2).

The parameters arrive as a tree of tensors with the paths the benchmark draws
(``param_specs``); the stacked layer leaves (leading dim = layers) are cut
into one tensor per layer, so a layer's gradient is its own leaf.  Nothing
here imports the program.

``PORT_FIXED`` and ``port_fields`` say which of the program's
architectures this reference stands for: the harness refuses a
configuration whose ``port_arch`` differs from ``PORT_FIXED``, and sets the
sizes ``port_fields`` names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

# ---------------------------------------------------------------------------
# The program's architectures this reference stands for
# ---------------------------------------------------------------------------

# what this reference implements, as the port's ModelConfig fields
PORT_FIXED = dict(block_pattern=("attn",), rope_type="rope", norm_type="rmsnorm", act="silu",
                  qkv_bias=False, qk_norm=False, attn_softcap=0.0, logit_softcap=0.0,
                  sliding_window=0, embed_scale=False, learned_pos=False, input_mode="tokens",
                  encoder_layers=0, moe_pattern=(), moe_d_ff=0)
# configuration file key -> the port's ModelConfig field
PORT_FIELDS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "num_local_experts": "num_experts", "num_experts_per_tok": "top_k",
    "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype", "rope_theta": "rope_theta",
    "router_aux_coef": "router_aux_coef",
}


def port_fields(cfg: dict) -> dict:
    """The port's ModelConfig fields a configuration file sets."""
    out = {field: cfg[key] for key, field in PORT_FIELDS.items() if key in cfg}
    out["moe"] = bool(cfg.get("num_local_experts", 0))
    return out


# ---------------------------------------------------------------------------
# The parameter tree the benchmark draws
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sizes:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    experts: int
    top_k: int
    tied: bool
    dtype: torch.dtype
    rope_theta: float
    eps: float
    aux_coef: float

    @property
    def moe(self) -> bool:
        return self.experts > 0


def sizes(cfg: dict) -> Sizes:
    """The sizes of a configuration file (HF-style keys)."""
    return Sizes(
        layers=cfg["num_hidden_layers"], d=cfg["hidden_size"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
        ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
        tied=cfg["tie_word_embeddings"], dtype=getattr(torch, cfg["torch_dtype"]),
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        aux_coef=float(cfg.get("router_aux_coef", 0.0)))


def param_specs(z: Sizes) -> Dict[Tuple[str, ...], Tuple[tuple, torch.dtype, float]]:
    """path -> (shape, dtype, std); std 0 means a norm scale of ones."""
    L, d, nh, nkv, hd, f = z.layers, z.d, z.heads, z.kv_heads, z.head_dim, z.ff
    out_std = 0.02 / max(1.0, math.sqrt(2.0 * L))
    dt = z.dtype
    s = {("embed", "table"): ((z.vocab, d), dt, 0.02)}
    if not z.tied:
        s[("unembed", "table")] = ((d, z.vocab), dt, 0.02)
    g = ("groups", "b0")
    s[g + ("norm1", "scale")] = ((L, d), dt, 0.0)
    s[g + ("attn", "wq")] = ((L, d, nh, hd), dt, 0.02)
    s[g + ("attn", "wk")] = ((L, d, nkv, hd), dt, 0.02)
    s[g + ("attn", "wv")] = ((L, d, nkv, hd), dt, 0.02)
    s[g + ("attn", "wo")] = ((L, nh, hd, d), dt, out_std)
    s[g + ("norm2", "scale")] = ((L, d), dt, 0.0)
    if z.moe:
        E = z.experts
        s[g + ("moe", "router")] = ((L, d, E), torch.float32, 0.02)
        s[g + ("moe", "wi")] = ((L, E, d, f), dt, 0.02)
        s[g + ("moe", "wg")] = ((L, E, d, f), dt, 0.02)
        s[g + ("moe", "wo")] = ((L, E, f, d), dt, out_std)
    else:
        s[g + ("mlp", "wi")] = ((L, d, f), dt, 0.02)
        s[g + ("mlp", "wg")] = ((L, d, f), dt, 0.02)
        s[g + ("mlp", "wo")] = ((L, f, d), dt, out_std)
    s[("final_norm", "scale")] = ((d,), dt, 0.0)
    return s


def stacked(path: Tuple[str, ...]) -> bool:
    return path[0] == "groups"


# ---------------------------------------------------------------------------
# Products in the stated precision or the control's
# ---------------------------------------------------------------------------


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x scaled per tensor so its largest value is ``top``, cast to ``dtype``
    and back."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def quantizers(precision: str):
    """(forward operand rounding, gradient rounding) of a precision."""
    if precision == "f32":
        return None, None
    if precision == "tf32":
        return _round_tf32, _round_tf32
    if precision == "fp8":
        return (lambda x: _fp8(x, torch.float8_e4m3fn, 448.0),
                lambda x: _fp8(x, torch.float8_e5m2, 57344.0))
    raise ValueError(f"unknown precision {precision!r}")


class _LowMatmul(torch.autograd.Function):
    """a @ b (same batch dims) with both operands rounded in the forward and
    the output gradient rounded in the backward, as a low-precision GEMM
    sees them."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        qa, qb = fwd(a), fwd(b)
        ctx.save_for_backward(qa, qb)
        ctx.bwd = bwd
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        gq = ctx.bwd(g)
        return torch.matmul(gq, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), gq), None, None


def make_mm(precision: str):
    fwd, bwd = quantizers(precision)
    if fwd is None:
        return torch.matmul
    return lambda a, b: _LowMatmul.apply(a, b, fwd, bwd)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (b, h, s, hd): rotate the two halves of each head by position."""
    s, hd = x.shape[2], x.shape[3]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, z: Sizes, mm):
    b, s, d = h.shape
    nh, nkv, hd = z.heads, z.kv_heads, z.head_dim
    h2 = h.reshape(b * s, d)
    q = mm(h2, p["wq"].reshape(d, nh * hd)).reshape(b, s, nh, hd).transpose(1, 2)
    k = mm(h2, p["wk"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd).transpose(1, 2)
    v = mm(h2, p["wv"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd).transpose(1, 2)
    q, k = rope(q, z.rope_theta), rope(k, z.rope_theta)
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    scores = mm(q, k.transpose(-1, -2)) * (hd ** -0.5)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)  # (b, nh, s, hd)
    out = out.transpose(1, 2).reshape(b * s, nh * hd)
    return mm(out, p["wo"].reshape(nh * hd, d)).reshape(b, s, d)


def mlp(p, h, mm):
    b, s, d = h.shape
    h2 = h.reshape(b * s, d)
    a = F.silu(mm(h2, p["wg"])) * mm(h2, p["wi"])
    return mm(a, p["wo"]).reshape(b, s, d)


def route(router, h, top_k: int):
    """(probs (n, E) f32, the top-k experts (n, k)): the k largest
    probabilities, ties to the lower expert."""
    probs = torch.softmax(h.reshape(-1, h.shape[-1]) @ router, dim=-1)
    return probs, torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :top_k]


def route_gap(logits: torch.Tensor, experts: torch.Tensor, top_k: int) -> torch.Tensor:
    """The widest amount, over these tokens, by which a taken expert's
    router logit lies below this model's k-th largest: 0 where every token
    takes its own top k; a near tie that rounding flipped reads about the
    rounding, a wrong choice about the spacing of the logits."""
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1]
    taken = torch.gather(logits, 1, experts).min(-1).values
    return (kth - taken).clamp(min=0).max()


def moe(p, h, experts, counts, frac_tokens, n_total, z: Sizes, mm, gaps: Optional[list] = None):
    """(y, this block's share of the load-balance loss).  ``experts`` (n, k)
    are the routes to take, ``counts`` their tokens per expert (a host list),
    ``frac_tokens`` (E,) the routed share of every token of the batch: the
    loss's per-expert token fractions are batch-wide, so each block of rows
    adds E * sum(frac_tokens * its sum of probs) / n_total.  ``gaps``, if
    given, gets the ``route_gap`` of ``experts`` against this router."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    logits = x @ p["router"]  # the router stays float32
    if gaps is not None:
        gaps.append(route_gap(logits.detach(), experts, z.top_k))
    probs = torch.softmax(logits, dim=-1)
    gates = torch.gather(probs, 1, experts)
    gates = gates / gates.sum(-1, keepdim=True)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token = order // z.top_k
    xs = x[token]
    outs = []
    for e, seg in enumerate(torch.split(xs, counts)):
        if seg.shape[0]:
            a = F.silu(mm(seg, p["wg"][e])) * mm(seg, p["wi"][e])
            outs.append(mm(a, p["wo"][e]))
    out = torch.cat(outs) * gates.reshape(-1)[order][:, None]
    y = torch.zeros_like(x).index_add(0, token, out)
    aux = z.experts * torch.sum(frac_tokens * probs.sum(0)) / n_total
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Loss and gradients, in blocks of rows
# ---------------------------------------------------------------------------


def layer_params(w: Dict[Tuple[str, ...], object], l: int) -> dict:
    """The nested dict of layer ``l``'s tensors."""
    out: dict = {}
    for path, t in w.items():
        if stacked(path):
            node = out
            for k in path[2:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t[l]
    return out


def find_routes(w, tokens, z: Sizes, mm, rows: int) -> torch.Tensor:
    """(layers, b, s, k) experts this model picks for ``tokens``, by a
    forward pass without gradients."""
    routes = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], rows):
            x = w[("embed", "table")][tokens[r0:r0 + rows].long()]
            per = []
            for l in range(z.layers):
                p = layer_params(w, l)
                x = x + attention(p["attn"], rms_norm(x, p["norm1"]["scale"], z.eps), z, mm)
                h = rms_norm(x, p["norm2"]["scale"], z.eps)
                _, top = route(p["moe"]["router"], h, z.top_k)
                per.append(top.reshape(*h.shape[:2], z.top_k))
                y, _ = moe(p["moe"], h, top, _counts(top, z.experts), _frac(top, z), 1.0, z, mm)
                x = x + y
            routes.append(torch.stack(per))
    return torch.cat(routes, dim=1)


def _counts(top: torch.Tensor, E: int) -> List[int]:
    return torch.bincount(top.reshape(-1), minlength=E).tolist()


def _frac(top: torch.Tensor, z: Sizes) -> torch.Tensor:
    """The routed share of each expert over these tokens, over top_k."""
    n = top.shape[0] if top.dim() == 2 else top.shape[0] * top.shape[1]
    return torch.bincount(top.reshape(-1), minlength=z.experts).float() / (n * z.top_k)


def loss_and_grads(w, tokens, labels, z: Sizes, precision: str = "f32",
                   routes: Optional[torch.Tensor] = None, rows: int = 1,
                   gaps: Optional[list] = None):
    """(loss, ce, aux, grads {path: per-layer list or tensor}, routes) of a
    batch, computed ``rows`` rows at a time with each layer recomputed in the
    backward pass.  ``w`` maps paths to float32 tensors (stacked leaves as
    per-layer lists) that require grad.  A MoE model takes ``routes`` (layers,
    b, s, k) or finds its own; ``gaps`` gets each block's ``route_gap``."""
    mm = make_mm(precision)
    b, s = tokens.shape
    n_total = float(b * s)
    if z.moe and routes is None:
        routes = find_routes(w, tokens, z, mm, rows)
    fracs = counts = None
    if z.moe:
        fracs = [_frac(routes[l], z) for l in range(z.layers)]
        host = routes.cpu()
        counts = [[torch.bincount(host[l, r0:r0 + rows].reshape(-1), minlength=z.experts).tolist()
                   for r0 in range(0, b, rows)] for l in range(z.layers)]
    table = w[("embed", "table")]
    head = table if z.tied else w[("unembed", "table")]
    tot_ce = torch.zeros((), dtype=torch.float64, device=tokens.device)
    tot_aux = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for ci, r0 in enumerate(range(0, b, rows)):
        tk, lb = tokens[r0:r0 + rows].long(), labels[r0:r0 + rows].long()
        x = table[tk]
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for l in range(z.layers):
            p = layer_params(w, l)
            if z.moe:
                top = routes[l, r0:r0 + rows].reshape(-1, z.top_k)
                fn = (lambda x, p=p, top=top, c=counts[l][ci], fr=fracs[l]:
                      _block_moe(p, x, top, c, fr, n_total, z, mm, gaps))
            else:
                fn = lambda x, p=p: (_block_mlp(p, x, z, mm), None)  # noqa: E731
            x, a = ckpt.checkpoint(fn, x, use_reentrant=False)
            if a is not None:
                aux = aux + a
        x = rms_norm(x, w[("final_norm", "scale")], z.eps)
        x2 = x.reshape(-1, z.d)
        logits = mm(x2, head.T) if z.tied else mm(x2, head)
        ce_sum = F.cross_entropy(logits, lb.reshape(-1), reduction="sum")
        part = ce_sum / n_total + z.aux_coef * aux
        part.backward()
        tot_ce += ce_sum.detach().double() / n_total
        tot_aux += aux.detach().double()
    loss = tot_ce + z.aux_coef * tot_aux
    grads = {path: ([t.grad for t in v] if isinstance(v, list) else v.grad) for path, v in w.items()}
    return float(loss), float(tot_ce), float(tot_aux), grads, routes


def _block_mlp(p, x, z, mm):
    x = x + attention(p["attn"], rms_norm(x, p["norm1"]["scale"], z.eps), z, mm)
    return x + mlp(p["mlp"], rms_norm(x, p["norm2"]["scale"], z.eps), mm)


def _block_moe(p, x, top, counts, frac, n_total, z, mm, gaps=None):
    x = x + attention(p["attn"], rms_norm(x, p["norm1"]["scale"], z.eps), z, mm)
    y, aux = moe(p["moe"], rms_norm(x, p["norm2"]["scale"], z.eps), top, counts, frac, n_total, z, mm,
                 gaps)
    return x + y, aux


# ---------------------------------------------------------------------------
# AdamW with a float32 master, as the configuration states it
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Adam:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip_norm: float
    warmup: int
    total: int
    min_frac: float


def lr_at(opt: Adam, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_frac`` of the peak."""
    warm = min(step / max(opt.warmup, 1), 1.0)
    prog = min(max((step - opt.warmup) / max(opt.total - opt.warmup, 1), 0.0), 1.0)
    return opt.lr * warm * (opt.min_frac + (1 - opt.min_frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def adam_step(state: dict, grads: dict, opt: Adam):
    """One AdamW step on ``state`` = {"master", "m", "v": {path: f32 tensor},
    "step": int}, in place.  Returns the clipped gradient {path: tensor}."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    scale = min(opt.clip_norm / max(gnorm, 1e-12), 1.0)
    state["step"] += 1
    t = state["step"]
    lr = lr_at(opt, t)
    b1c, b2c = 1 - opt.b1 ** t, 1 - opt.b2 ** t
    clipped = {}
    for path, g in grads.items():
        g = g * scale
        clipped[path] = g
        m = state["m"][path].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
        v = state["v"][path].mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
        p = state["master"][path]
        p.sub_(lr * ((m / b1c) / ((v / b2c).sqrt() + opt.eps) + opt.weight_decay * p))
    return clipped, gnorm


def forward_weights(state: dict, dtypes: dict, layers_of: dict) -> dict:
    """The weights a step computes with: each master rounded to its leaf's
    stored type, in float32, stacked leaves cut per layer, requiring grad."""
    w = {}
    for path, mst in state["master"].items():
        x = mst.to(dtypes[path]).float()
        if path in layers_of:
            w[path] = [x[l].clone().requires_grad_(True) for l in range(layers_of[path])]
        else:
            w[path] = x.clone().requires_grad_(True)
    return w


def train_steps(state: dict, batches: List[Tuple[torch.Tensor, torch.Tensor]], z: Sizes,
                opt: Adam, dtypes: dict, *, precision: str = "f32",
                routes: Optional[List[torch.Tensor]] = None, rows: int = 1) -> dict:
    """Run len(batches) steps from ``state`` (changed in place).  Returns
    {"losses": [...], "grads": first step's clipped gradient {path: tensor},
    "routes": the routes each step took, "route_gap": the widest
    ``route_gap`` of those routes against this model's routers (MoE only)}."""
    layers_of = {p: z.layers for p in state["master"] if stacked(p)}
    out = {"losses": [], "grads": None, "routes": [], "route_gap": None}
    gaps: list = []
    for i, (tokens, labels) in enumerate(batches):
        w = forward_weights(state, dtypes, layers_of)
        r = routes[i] if routes is not None else None
        loss, _, _, grads, used = loss_and_grads(w, tokens, labels, z, precision, r, rows, gaps)
        grads = {p: torch.stack(g) if isinstance(g, list) else g for p, g in grads.items()}
        del w
        clipped, _ = adam_step(state, grads, opt)
        out["losses"].append(loss)
        out["routes"].append(used)
        if i == 0:
            out["grads"] = clipped
        del grads, clipped
    if gaps:
        out["route_gap"] = float(torch.stack(gaps).max())
    return out
