"""The port's orchestration core on the CPU against the JAX package's.

Simulator runs, the cross-cell batched sweep and the process-pool sweep
of ``repro_torch.core`` with ``device="cpu"`` (the K4 decide through its
plain PyTorch version) must produce the reference's summaries exactly,
minus the wall-clock ``TIMING_KEYS``.  The numbers are numpy float64 on
both sides, so there is no tolerance.
"""
import numpy as np
import pytest
import torch

from repro.core import feasibility as ref_fz
from repro.core import simulator as ref_sim
from repro.core import sweep as ref_sweep
from repro_torch.core import feasibility as fz
from repro_torch.core import simulator as port_sim
from repro_torch.core import sweep as port_sweep
from repro_torch.core.orchestrator import make_policy

GB = 1e9
# copies of benchmarks/run.py's FLEET_COMPILED_OVERRIDES and
# SWEEP_BATCHED_SPEC, cut to a 1-day fleet and to 8 seeds
FLEET_DAY = dict(n_sites=100, n_jobs=1000, arrival_skew=(1.0,) * 100, days=1)
SWEEP_CUT = dict(
    scenarios=("paper-table6", "forecastable-brownouts"),
    policies=("feasibility-aware",), seeds=tuple(range(8)),
    overrides=dict(n_jobs=6, days=1, orch_dt_s=1800.0))


def _strip(summary):
    return {k: v for k, v in summary.items() if k not in ref_sweep.TIMING_KEYS}


@pytest.mark.parametrize("scenario,policy,overrides", [
    ("paper-table6", "feasibility-aware", None),
    ("forecastable-brownouts", "plan-ahead", None),
    ("chaos-monkey", "feasibility-aware", None),
    ("battery-bridging", "receding-horizon", None),
    ("flaky-wan", "oracle", None),
    ("forecastable-brownouts", "feasibility-aware", FLEET_DAY),
], ids=["table6-fa", "brownouts-plan-ahead", "chaos-fa", "battery-rh",
        "flaky-wan-oracle", "fleet-100-sites-1-day"])
def test_simulator_matches_reference(scenario, policy, overrides):
    want = ref_sim.ClusterSimulator.from_scenario(
        scenario, policy, overrides=overrides).run()
    got = port_sim.ClusterSimulator.from_scenario(
        scenario, policy, overrides=overrides, device="cpu").run()
    assert _strip(got.summary()) == _strip(want.summary())
    assert got.migrations == want.migrations


def test_run_cells_batched_matches_reference():
    """The 2-scenario x 8-seed cut of the batched sweep: per-run
    summaries equal the reference's batched runner's."""
    want = ref_sweep.run_cells_batched(
        ref_sweep.SweepSpec(**SWEEP_CUT).cells(keep_results=False),
        keep_results=False)
    got = port_sweep.run_cells_batched(
        port_sweep.SweepSpec(**SWEEP_CUT).cells(keep_results=False),
        keep_results=False, device="cpu")
    assert len(got.runs) == 16
    assert got.deterministic_summaries() == want.deterministic_summaries()


def test_run_cells_pool_matches_reference():
    """The process-pool engine (two workers) gives the reference's
    summaries, and the same as the batched runner."""
    spec = dict(SWEEP_CUT, seeds=(0, 1, 2))
    want = ref_sweep.run_cells(ref_sweep.SweepSpec(**spec).cells(), workers=2)
    got = port_sweep.run_cells(port_sweep.SweepSpec(**spec).cells(), workers=2,
                               device="cpu")
    assert got.workers == 2
    assert got.deterministic_summaries() == want.deterministic_summaries()
    batched = port_sweep.run_cells_batched(port_sweep.SweepSpec(**spec).cells(),
                                           device="cpu")
    assert batched.deterministic_summaries() == got.deterministic_summaries()


def test_run_policy_comparison_matches_reference():
    pols = ("static", "energy-only", "feasibility-aware", "oracle")
    want = ref_sim.run_policy_comparison(
        policies=pols, scenario="paper-table6", overrides=dict(days=2, n_jobs=60))
    got = port_sim.run_policy_comparison(
        policies=pols, scenario="paper-table6", overrides=dict(days=2, n_jobs=60),
        device="cpu")
    assert list(got) == list(want)
    for name in pols:
        assert _strip(got[name].summary()) == _strip(want[name].summary()), name


def test_stochastic_feasible_matches_reference_numpy():
    rng = np.random.default_rng(3)
    sizes = rng.uniform(0.1, 400, 64) * GB
    bws = rng.choice([0.0, 1e9, 2.5e9, 10e9], 64)
    windows = rng.uniform(-600, 9 * 3600, 64)
    sigmas = rng.uniform(0, 1800, 64)
    for eps in (0.01, 0.05, 0.2):
        want = ref_fz.stochastic_feasible(sizes, bws, windows, sigmas, eps=eps)
        got = fz.stochastic_feasible(sizes, bws, windows, sigmas, eps=eps)
        assert isinstance(want, np.ndarray)
        np.testing.assert_array_equal(got, want)
    got = fz.stochastic_feasible(5 * GB, 10e9, 3600.0, 900.0)
    assert bool(got) == bool(ref_fz.stochastic_feasible(5 * GB, 10e9, 3600.0, 900.0))


def test_chunked_engine_builds_the_chunked_plane():
    """The default serving engine builds the chunked fast path; "event"
    still builds the per-event plane."""
    from repro_torch.core.serving import ServingPlane
    from repro_torch.core.serving_kernels import ChunkedServingPlane

    ov = dict(days=1, n_jobs=10)
    sim = port_sim.ClusterSimulator.from_scenario(
        "train-plus-serve", "static", overrides=ov, device="cpu")
    assert sim.cfg.serving_engine == "chunked"
    assert type(sim.serving) is ChunkedServingPlane
    sim = port_sim.ClusterSimulator.from_scenario(
        "train-plus-serve", "static", overrides=dict(ov, serving_engine="event"),
        device="cpu")
    assert type(sim.serving) is ServingPlane


def test_device_reaches_k4_policies_only():
    pol = make_policy("feasibility-aware", device="cpu")
    assert pol.scores_on_device and pol.device.type == "cpu"
    assert make_policy("plan-ahead", device="cpu").device.type == "cpu"
    assert make_policy("oracle", device="cpu").device.type == "cpu"
    static = make_policy("static", device="cpu")
    assert not static.scores_on_device and not hasattr(static, "device")
    pol.device = torch.device("cuda")  # made for the card ...
    with pytest.raises(ValueError, match="scores on"):  # ... run on the CPU
        port_sim.ClusterSimulator(port_sim.SimConfig(n_jobs=4, days=1), pol,
                                  device="cpu")


def test_default_device_is_the_card():
    """Without a card, asking for the default device raises: nothing
    falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_policy("feasibility-aware")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sim.ClusterSimulator.from_scenario("paper-table6", "static")
