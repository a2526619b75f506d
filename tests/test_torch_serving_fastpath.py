"""The port's chunked serving engine (``repro_torch.core.serving_kernels``)
on the CPU against the JAX package's, and against the port's own per-event
plane.

Each regime of ``tests/test_serving_fastpath.py``, cut to one day and a
lower rate (the overflow regime to a one-batch queue, so that it still
drops at 0.2 req/s), runs three times: the reference under its default chunked
engine, the port under its default chunked engine, and the port with
``serving_engine="event"``.  The three summaries (minus the wall-clock
``TIMING_KEYS``), tick counts and request counts must be exactly equal:
the serving plane is numpy float64 host code on both sides and the two
engines are bit-identical, so there is no tolerance.
"""
import json

import numpy as np
import pytest

from repro.core import serving as ref_serving
from repro.core import serving_kernels as ref_sk
from repro.core import simulator as ref_sim
from repro.core.sweep import TIMING_KEYS
from repro_torch.core import energy, feasibility as fz
from repro_torch.core import serving as port_serving
from repro_torch.core import serving_kernels as port_sk
from repro_torch.core import simulator as port_sim

#: the reference suite's two-site fleet for its hot-stream regimes
TWO_SITES = dict(n_sites=2, arrival_skew=(1.0, 1.0))
COUNTS = ("requests_arrived", "requests_served", "requests_dropped",
          "requests_shed", "slo_violations")


def _strip(summary) -> str:
    """The summary minus its timing keys, as sorted JSON (NaN, the mean
    JCT of a run without jobs, compares equal there)."""
    return json.dumps({k: v for k, v in summary.items() if k not in TIMING_KEYS},
                      sort_keys=True)


def _port(scenario, policy, engine, overrides, profile):
    ov = dict(overrides, serving_engine=engine)
    if profile is not None:
        ov["serving"] = port_serving.ServingProfile(**profile)
    sim = port_sim.ClusterSimulator.from_scenario(scenario, policy, overrides=ov,
                                                  device="cpu")
    return sim, sim.run()


def _ref(scenario, policy, overrides, profile):
    ov = dict(overrides)
    if profile is not None:
        ov["serving"] = ref_serving.ServingProfile(**profile)
    sim = ref_sim.ClusterSimulator.from_scenario(scenario, policy, overrides=ov)
    return sim, sim.run()


def _assert_parity(scenario, policy, profile=None, **overrides):
    """Reference chunked == port chunked == port per-event, each package
    with its own ``ServingProfile(**profile)``.  Returns the port's chunked
    result."""
    ref, want = _ref(scenario, policy, overrides, profile)
    chunked_sim, got = _port(scenario, policy, "chunked", overrides, profile)
    event_sim, event = _port(scenario, policy, "event", overrides, profile)
    assert type(ref.serving) is ref_sk.ChunkedServingPlane
    assert type(chunked_sim.serving) is port_sk.ChunkedServingPlane
    assert type(event_sim.serving) is port_serving.ServingPlane
    assert _strip(got.summary()) == _strip(want.summary())
    assert _strip(event.summary()) == _strip(got.summary())
    assert got.ticks == want.ticks == event.ticks
    for key in COUNTS:
        assert getattr(got, key) == getattr(want, key) == getattr(event, key), key
    return got


@pytest.mark.parametrize("router", ["nearest", "green-first", "carbon-slo"])
def test_chunked_matches_reference_across_routers(router):
    r = _assert_parity("paper-table6", "static", dict(req_per_s_per_site=0.01),
                       n_jobs=0, days=1, serving_router=router)
    assert r.requests_served > 0


def test_chunked_matches_reference_on_train_plus_serve():
    """Training migrations (K4's plain version) interleave with serving
    spans."""
    r = _assert_parity("train-plus-serve", "feasibility-aware", days=1)
    assert r.requests_served > 0 and r.completed > 0 and r.migrations > 0


def test_chunked_matches_reference_at_overflow_boundary():
    r = _assert_parity(
        "paper-table6", "static",
        dict(req_per_s_per_site=0.2, max_batch=2, max_queue_batches=1, replicas_per_site=1),
        n_jobs=0, days=1, serving_router="nearest", **TWO_SITES)
    assert r.requests_dropped > 0


def test_chunked_matches_reference_with_zero_replica_site():
    r = _assert_parity(
        "paper-table6", "static",
        dict(req_per_s_per_site=0.03, replicas_by_site=(2, 0, 2, 2, 2)),
        n_jobs=0, days=1, serving_router="nearest")
    assert r.requests_served > 0


def test_chunked_matches_reference_across_fault_edges():
    r = _assert_parity("blackout-cascade", "plan-ahead", dict(req_per_s_per_site=0.01),
                       days=1, serving_router="carbon-slo")
    assert r.requests_arrived > 0


def test_chunked_matches_reference_at_max_batch_fill():
    r = _assert_parity("paper-table6", "static", dict(req_per_s_per_site=0.1, max_batch=2),
                       n_jobs=0, days=1, serving_router="nearest", **TWO_SITES)
    assert r.requests_served > 0


class _RefNearestSubclass(ref_serving.NearestRouter):
    name = "nearest-subclass"


class _PortNearestSubclass(port_serving.NearestRouter):
    name = "nearest-subclass"


def test_router_subclass_takes_the_per_event_plane(monkeypatch):
    """A router with no exact kernel mirror (a subclass may override
    ``route``) runs on the per-event plane under the default engine, in
    both packages, with the same summary."""
    monkeypatch.setitem(ref_serving._ROUTERS, "nearest-subclass", _RefNearestSubclass)
    monkeypatch.setitem(port_serving._ROUTERS, "nearest-subclass", _PortNearestSubclass)
    ov = dict(n_jobs=0, days=1, serving_router="nearest-subclass")
    profile = dict(req_per_s_per_site=0.01)
    assert not port_sk.supports_router(_PortNearestSubclass())
    ref, want = _ref("paper-table6", "static", ov, profile)
    port, got = _port("paper-table6", "static", "chunked", ov, profile)
    assert type(ref.serving) is ref_serving.ServingPlane
    assert type(port.serving) is port_serving.ServingPlane
    assert got.requests_served > 0
    assert _strip(got.summary()) == _strip(want.summary())


def test_conservation_and_ledger_audit():
    """inference-diurnal for a day under the chunked engine: every request
    is served, dropped or shed, and the energy ledger balances per site
    (``audit`` raises otherwise)."""
    sim, r = _port("inference-diurnal", "static", "chunked", dict(days=1), None)
    assert type(sim.serving) is port_sk.ChunkedServingPlane
    assert r.requests_arrived > 0
    assert r.requests_arrived == r.requests_served + r.requests_dropped + r.requests_shed
    sim.ledger.audit()


# ---------------------------------------------------------------------------
# The core leftovers: float32 feasibility grids and the energy table
# ---------------------------------------------------------------------------

GB = 1e9


def test_classify_by_size_matches_reference():
    """Float32 bands in both packages: 10 GB and 100 GB are both class B
    (100 GB rounds down in float32, as does the threshold)."""
    from repro.core import feasibility as ref_fz

    sizes = np.array([1e9, 9.99e9, 10 * GB, 5e10, 100 * GB, 1.0001e11, 2e11, 0.0])
    want = np.asarray(ref_fz.classify_by_size(sizes))
    got = fz.classify_by_size(sizes, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype.is_floating_point is False and str(got.dtype) == "torch.int32"
    assert [int(fz.classify_by_size(s, device="cpu")) for s in (10 * GB, 100 * GB)] == [1, 1]
    assert [int(ref_fz.classify_by_size(s)) for s in (10 * GB, 100 * GB)] == [1, 1]


def test_phase_diagram_matches_reference_on_fig2_grid():
    """The Fig. 2 grid of benchmarks/fig2_phase.py: every array equal."""
    from repro.core import feasibility as ref_fz

    sizes = np.logspace(-1, 3, 60)
    bws = np.logspace(-1, 2, 40)
    want = ref_fz.phase_diagram(sizes, bws)
    got = fz.phase_diagram(sizes, bws, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert 0 < got["feasible"].sum() < got["feasible"].size


def test_site_utility_and_feasible_destinations_match_reference():
    from repro.core import feasibility as ref_fz

    rng = np.random.default_rng(5)
    ren, load = rng.uniform(0, 1, 32), rng.uniform(0, 1, 32)
    for w in (fz.UtilityWeights(), fz.UtilityWeights(gamma=0.7, beta=1.3)):
        want = np.asarray(ref_fz.site_utility(ren, load, ref_fz.UtilityWeights(w.gamma, w.beta)))
        np.testing.assert_array_equal(fz.site_utility(ren, load, w, device="cpu").numpy(), want)
    bws = rng.choice([0.0, 1e8, 1e9, 2.5e9, 10e9], 64)
    windows = rng.uniform(0, 6 * 3600, 64)
    for size in (1 * GB, 6 * GB, 33 * GB, 40 * GB, 280 * GB):
        want = ref_fz.feasible_destinations(size, bws, windows)
        got = fz.feasible_destinations(size, bws, windows, device="cpu")
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)


def test_energy_table_matches_reference():
    from repro.core import energy as ref_energy

    assert list(energy.TABLE_I) == list(ref_energy.TABLE_I)
    for key, hw in energy.TABLE_I.items():
        ref_hw = ref_energy.TABLE_I[key]
        assert (hw.name, hw.power_kw, hw.perf_per_watt, hw.usd_per_tflop, hw.peak_tflops) == (
            ref_hw.name, ref_hw.power_kw, ref_hw.perf_per_watt, ref_hw.usd_per_tflop,
            ref_hw.peak_tflops)
        for sps, frac in ((100.0, 1.0), (333.3, 0.25)):
            assert energy.joules_per_sample(hw, sps, frac) == ref_energy.joules_per_sample(
                ref_hw, sps, frac)
    assert energy.ENERGY_PER_SAMPLE_MJ == ref_energy.ENERGY_PER_SAMPLE_MJ
    assert (energy.P_SYS_TRANSFER_KW, energy.P_NODE_COMPUTE_KW) == (
        ref_energy.P_SYS_TRANSFER_KW, ref_energy.P_NODE_COMPUTE_KW)
    assert energy.node_energy_kwh(0.75, 3.0) == ref_energy.node_energy_kwh(0.75, 3.0)
