"""The dropless routed MoE (``models/moe.py``: rows sorted by expert, the
grouped expert MLP's plain version ``kernels/ref.py::grouped_mlp_ref``, the
gated combine) against the JAX package's dense dispatch on the CPU.

Each case draws a MoE layer and its input with numpy from a seed and holds
the port's ``apply_moe`` to ``repro.models.moe.apply_moe(impl="dense")``:
the output, the aux loss, and the gradients of x, the router and wg / wi /
wo of a loss that weighs every output element by a fixed random cotangent
plus the aux loss.  Shapes: the reduced granite-moe, phi3.5-moe and jamba
MoE layers, and granite's 32 experts top-8 at small widths.  Routings: as
drawn; one expert that no token takes; every token's first choice on one
expert (and top-1: every row in one group); router columns equal in pairs,
so that gates tie exactly and the lower index wins, as ``jax.lax.top_k``'s.

Tolerances: float32 on both sides, differing only in the order of sums
(the port sums a token's k rows, the reference all E experts' with zeros
among them): outputs 1e-5, the aux loss 1e-6 relative, gradients 1e-4 of
each leaf's largest element (tests/test_torch_archs.py's).

Also: the sort and the combine are deterministic (two forwards equal bit
for bit); K5's custom ops trace on fake tensors (the dry-run's path, its
FLOP formula the routed work); ``moe.rows_computed`` counts b s k rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import moe as jmoe
from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import moe

TOL, AUX_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
B, S = 2, 24

# (name, d, f, E, k): the reduced configs' MoE layers, and granite's routing at small widths
SHAPES = [(a, *(lambda c: (c.d_model, c.expert_d_ff, c.num_experts, c.top_k))(
    get_config(a).reduced())) for a in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
                                        "jamba-v0.1-52b")] + [("granite-32x8", 32, 16, 32, 8)]
ROUTINGS = ("drawn", "idle_expert", "one_expert", "one_expert_top1", "ties")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _layer(d: int, f: int, E: int, routing: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.3,
         "wi": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
         "wg": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((E, f, d)).astype(np.float32) * 0.1}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if routing == "idle_expert":  # expert 1's probability is nought for every token
        p["router"][:, 1] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        p["router"][0, 1] = -40.0
    elif routing.startswith("one_expert"):  # expert E - 1 first for every token, unsaturated
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        p["router"][0, E - 1] = 10.0
    elif routing == "ties":  # experts 2i and 2i + 1 share a router column
        p["router"][:, 1::2] = p["router"][:, 0::2]
    return p, x


def _jax_side(p, x, cot, k):
    def loss(pj, xj):
        y, aux = jmoe.apply_moe(pj, xj, top_k=k, act="silu", impl="dense")
        return jnp.sum(y * cot) + aux, (y, aux)

    pj = {n: jnp.asarray(a) for n, a in p.items()}
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        pj, jnp.asarray(x))
    return np.asarray(y), float(aux), {n: np.asarray(g) for n, g in gp.items()}, np.asarray(gx)


def _port_side(p, x, cot, k):
    pt = {n: t.requires_grad_(True) for n, t in params_from_numpy(p, "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply_moe(pt, xt, top_k=k, act="silu")
    (torch.sum(y * torch.from_numpy(cot)) + aux).backward()
    return (y.detach().numpy(), float(aux), {n: t.grad.numpy() for n, t in pt.items()},
            xt.grad.numpy())


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_routed_moe_matches_dense_reference(shape, routing):
    _, d, f, E, k = shape
    if routing == "one_expert_top1":
        k = 1
    p, x = _layer(d, f, E, routing)
    cot = np.random.default_rng(1).standard_normal((B, S, d)).astype(np.float32)
    want_y, want_aux, want_gp, want_gx = _jax_side(p, x, cot, k)
    got_y, got_aux, got_gp, got_gx = _port_side(p, x, cot, k)
    np.testing.assert_allclose(got_y, want_y, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_aux, want_aux, rtol=AUX_RTOL, atol=0)
    for name, g in [("x", got_gx)] + sorted(got_gp.items()):
        want = want_gx if name == "x" else want_gp[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, want, atol=GRAD_TOL * scale, rtol=0, err_msg=name)
    routes = moe._route(params_from_numpy(p, "cpu"), torch.from_numpy(x), k)[1]
    if routing == "idle_expert":
        assert not (routes == 1).any()
        assert np.all(got_gp["wg"][1] == 0) and np.all(got_gp["wo"][1] == 0)
    elif routing.startswith("one_expert"):
        assert (routes[..., 0] == E - 1).all()
    elif routing == "ties":  # each tied pair's lower index ranks first
        gates, routes, _ = moe._route(params_from_numpy(p, "cpu"), torch.from_numpy(x), k)
        assert torch.equal(gates[..., 0], gates[..., 1]) and (routes[..., 0] % 2 == 0).all()
        assert torch.equal(routes[..., 1], routes[..., 0] + 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_routed_moe_is_deterministic_and_counts_routed_rows(shape):
    """Two forwards equal bit for bit; the grouped MLP computes b s k rows,
    the rows routed: a useful share of 1."""
    _, d, f, E, k = shape
    p, x = _layer(d, f, E, "drawn", seed=3)
    pt, xt = params_from_numpy(p, "cpu"), torch.from_numpy(x)
    spans.reset("moe.")
    first = moe.apply_moe(pt, xt, top_k=k, act="silu")[0]
    assert torch.equal(first, moe.apply_moe(pt, xt, top_k=k, act="silu")[0])
    got = spans.counts()
    assert got["moe.rows_computed"] == got["moe.rows_routed"] == 2 * B * S * k
    spans.reset("moe.")


@pytest.mark.parametrize("groups", [None, 2], ids=["whole", "block"])
def test_grouped_mlp_ops_trace_on_fake_tensors(groups):
    """On fake tensors (the mesh dry-run) ``ops.grouped_mlp`` goes through
    K5's custom ops, forward and backward, with no launch; the FLOP
    counter reads the routed work: 6 d f a row forward, 12 backward, on a
    block of experts its share of the rows."""
    rows, d, f, E = 48, 16, 8, 4
    g = groups or E
    with FakeTensorMode():
        xs = torch.empty(rows, d).requires_grad_(True)
        ws = [torch.empty(g, d, f).requires_grad_(True), torch.empty(g, d, f).requires_grad_(True),
              torch.empty(g, f, d).requires_grad_(True)]
        offsets = torch.zeros(g + 1, dtype=torch.int64)
        ops.reset_launch_counts()
        with FlopCounterMode(display=False) as fc:
            out = ops.grouped_mlp(xs, *ws, offsets, act="silu", num_experts=E)
            out.sum().backward()
    assert tuple(out.shape) == (rows, d) and tuple(xs.grad.shape) == (rows, d)
    assert [tuple(w.grad.shape) for w in ws] == [(g, d, f), (g, d, f), (g, f, d)]
    assert ops.launch_counts()["grouped_gemm"] == 0
    ops_counted = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    share = g / E
    assert ops_counted["repro_torch.grouped_mlp_fwd"] == int(6 * rows * d * f * share)
    assert ops_counted["repro_torch.grouped_mlp_bwd"] == int(12 * rows * d * f * share)


def test_grouped_mlp_ref_leaves_other_rows_zero():
    """On a block of experts the rows outside its groups give 0, and each
    group's rows go through that group's weights alone."""
    rng = np.random.default_rng(4)
    rows, d, f = 10, 8, 8
    xs = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    wg, wi = (torch.from_numpy(rng.standard_normal((2, d, f)).astype(np.float32))
              for _ in range(2))
    wo = torch.from_numpy(rng.standard_normal((2, f, d)).astype(np.float32))
    offsets = torch.tensor([3, 5, 9])
    out = ops.grouped_mlp(xs, wg, wi, wo, offsets, act="silu", num_experts=4)
    assert torch.equal(out[:3], torch.zeros(3, d)) and torch.equal(out[9:], torch.zeros(1, d))
    for e, (lo, hi) in enumerate(((3, 5), (5, 9))):
        seg = xs[lo:hi]
        want = (torch.nn.functional.silu(seg @ wg[e]) * (seg @ wi[e])) @ wo[e]
        torch.testing.assert_close(out[lo:hi], want, rtol=1e-6, atol=1e-6)


def test_chip_smoke_k5_phase_on_cpu(monkeypatch, tmp_path):
    """chip_smoke's K5 and row-sum checks (check_grouped_gemm,
    check_grouped_no_sync, check_moe_rows), which the card runs at granite's and phi3.5-moe's layer shapes, on the
    CPU at small ones with the plain versions standing in
    (tests/test_torch_archs.py's use_plain_stand_ins): every comparison,
    bit-identity, block and launch count they make runs here."""
    from test_torch_archs import use_plain_stand_ins

    from repro_torch.kernels import grouped_gemm as gg

    chip_smoke = use_plain_stand_ins(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, "grouped_mlp_cuda", gg.grouped_mlp_cuda)
    monkeypatch.setattr(chip_smoke, "grouped_mlp_bwd_cuda", gg.grouped_mlp_bwd_cuda)
    monkeypatch.setattr(chip_smoke, "moe_rows_sum_cuda", gg.moe_rows_sum_cuda)
    monkeypatch.setattr(chip_smoke, "moe_combine_bwd_cuda", gg.moe_combine_bwd_cuda)
    monkeypatch.setattr(chip_smoke, "GROUPED_CASES", [
        ("granite-moe-1b-a400m", 64, 32, 16, 8, 4, torch.bfloat16),
        ("ragged", 30, 24, 40, 7, 2, torch.bfloat16),
        ("ragged", 30, 24, 40, 7, 2, torch.float32)])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    keys = {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}
    assert set(chip_smoke.check_grouped_gemm(torch.device("cpu"))) == keys
    assert set(chip_smoke.check_moe_rows(torch.device("cpu"))) == keys
