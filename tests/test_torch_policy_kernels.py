"""Parity of the port's K4 decide (plain PyTorch version, on the CPU)
with the JAX package's float64 numpy pass ``_score_numpy``.

The same numpy batches — built by the reference's ``batch_from_states``
from ``tests.test_vectorized.random_state`` cells, as
``tests/test_policy_kernels.py`` builds them, or by hand for ties,
penalties, dead links and dark fleets — go through
``repro.core.policy_kernels._score_numpy`` and through the port's
``ops.decide_dest`` on CPU tensors.  Destinations are integers: no
tolerance, every case must be equal.  The CUDA kernel is held against
the same plain version on the card by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import policy_kernels as ref_pk
from repro.core import state as ref_state
from repro.core.orchestrator import FeasibilityAwarePolicy as RefFeasibilityAware
from repro_torch.core import policy_kernels as pk
from repro_torch.core import state as port_state
from repro_torch.core.orchestrator import FeasibilityAwarePolicy
from repro_torch.kernels import decide as dc
from repro_torch.kernels import ops
from tests.test_policy_kernels import PARAM_SETS, _cells

GB = 1e9
HOUR = 3600.0


def _port_dest(batch, params: pk.ScoreParams) -> np.ndarray:
    jobs, sites = pk.pack_batch(batch)
    dest = ops.decide_dest(torch.from_numpy(jobs), torch.from_numpy(sites),
                           torch.from_numpy(np.ascontiguousarray(batch.bw)),
                           **pk.kernel_scalars(params))
    assert dest.dtype == torch.int64
    return dest.numpy()


def _params(**kw):
    return (pk.ScoreParams(**dataclasses.asdict(RefFeasibilityAware(**kw)._params())),
            RefFeasibilityAware(**kw)._params())


@pytest.mark.parametrize("kwargs", PARAM_SETS)
@pytest.mark.parametrize("seed", range(12))
def test_decide_dest_matches_reference_numpy(seed, kwargs):
    """Random cells: the port's K4 plain version and its ``_score_numpy``
    copy equal the reference's ``_score_numpy`` on every row, padded rows
    included."""
    states, cands = _cells(seed, 4)
    if not states:
        pytest.skip("no live cells at this seed")
    port_params, ref_params = _params(**kwargs)
    batch = ref_pk.batch_from_states(states, cands)
    want = ref_pk._score_numpy(batch, ref_params)
    np.testing.assert_array_equal(_port_dest(batch, port_params), want)
    np.testing.assert_array_equal(pk._score_numpy(batch, port_params), want)


@pytest.mark.parametrize("seed", range(12))
def test_decide_dest_matches_reference_pallas(seed):
    """Where the reference holds its TPU kernel (interpret mode) equal to
    numpy, the port's K4 equals that kernel too."""
    states, cands = _cells(seed, 4)
    if not states:
        pytest.skip("no live cells at this seed")
    port_params, ref_params = _params()
    batch = ref_pk.batch_from_states(states, cands)
    np.testing.assert_array_equal(_port_dest(batch, port_params),
                                  np.asarray(ref_pk._score_pallas(batch, ref_params)))


@pytest.mark.parametrize("seed", range(4))
def test_port_batch_from_states_matches_reference(seed):
    """The port's cross-cell gather builds the reference's exact batch
    (16 cells of 2-5 sites: ragged in both axes)."""
    states, cands = _cells(seed, 16)
    got = pk.batch_from_states(states, cands)
    want = ref_pk.batch_from_states(states, cands)
    assert got.n_jobs == want.n_jobs and got.n_sites == want.n_sites
    for f in ("sizes", "t_loads", "rem", "s_i", "cur_green", "load_src",
              "bw", "W", "bq_load", "free_slots"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


# ---------------------------------------------------------------------------
# hand-built batches: one cell, K = 8 job rows, S = 8 site columns
# ---------------------------------------------------------------------------


def _batch(W, bw, *, size=5 * GB, s_i=0, free_slots=None, bq_load=None,
           rem=8 * HOUR, k=1):
    """k identical job rows at site ``s_i`` (the rest padding, as
    ``build_batch`` pads) against the given site columns and bw row."""
    S, K = 8, 8
    n = len(W)

    def site_col(vals, fill):
        out = np.full((1, S), fill, dtype=np.float64)
        out[0, :n] = vals
        return out

    def job_col(val, fill):
        out = np.full((1, K), fill, dtype=np.float64)
        out[0, :k] = val
        return out

    bw_full = np.zeros((1, K, S))
    bw_full[0, :k, :n] = bw
    free = np.ones((1, S), dtype=np.int64)
    free[0, :n] = free_slots if free_slots is not None else 1
    return ref_pk.ScoreBatch(
        sizes=job_col(size, 1.0), t_loads=job_col(10.3, 0.0),
        rem=job_col(rem, 0.0), cur_green=job_col(0.0, 0.0),
        load_src=job_col(0.5, 0.0),
        s_i=job_col(s_i, 0).astype(np.int32), bw=bw_full,
        W=site_col(W, 0.0),
        bq_load=site_col(bq_load if bq_load is not None else 0.25, 0.0),
        free_slots=free, n_jobs=(k,), n_sites=(n,))


_GREEN = 6 * HOUR
HAND_CASES = {
    # equal benefit at sites 1-3: site 2's lower tt wins over site 1
    "tie_lower_tt_wins_at_higher_sid": (
        _batch([0.0, _GREEN, _GREEN, _GREEN], [0.0, 1e9, 2e9, 1e9]), 2),
    # equal benefit and equal tt at sites 1-3: the lowest sid wins
    "tie_equal_tt_lowest_sid": (
        _batch([0.0, _GREEN, _GREEN, _GREEN], [0.0, 2e9, 2e9, 2e9]), 1),
    # site 1 has the longest window but no free slot: the penalty moves
    # the pick to site 2
    "free_slots_penalty": (
        _batch([0.0, 7 * HOUR, _GREEN], [0.0, 2e9, 2e9], free_slots=[1, 0, 1]), 2),
    # every slot full: the penalty hits every site alike
    "all_slots_full": (
        _batch([0.0, _GREEN, 7 * HOUR], [0.0, 2e9, 2e9], free_slots=[0, -1, 0]), 2),
    # no link anywhere: tt = inf fails every gate
    "zero_bandwidth_row": (_batch([0.0, _GREEN, _GREEN], [0.0, 0.0, 0.0]), -1),
    # a dark fleet: no window passes the energy gate
    "all_dark": (_batch([0.0, 0.0, 0.0], [0.0, 2e9, 2e9]), -1),
    # the best site is the source itself: excluded
    "source_excluded": (
        _batch([8 * HOUR, _GREEN, 0.0], [2e9, 1e9, 2e9], s_i=0), 1),
    # a class-C transfer (tt >= 300 s) is never migrated
    "class_c": (_batch([0.0, _GREEN], [0.0, 1e9], size=40 * GB), -1),
    # the queue term alone decides between two equal windows
    "queue_load": (
        _batch([0.0, _GREEN, _GREEN], [0.0, 2e9, 2e9], bq_load=[0.0, 0.75, 0.0]), 2),
    # several live rows in one cell, each scored alone
    "many_rows": (_batch([0.0, _GREEN, _GREEN], [0.0, 1e9, 2e9], k=5), 2),
}


@pytest.mark.parametrize("stoch", [False, True], ids=["det", "stoch"])
@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_decide_dest_hand_built(case, stoch):
    batch, expect = HAND_CASES[case]
    kwargs = dict(eps=0.05, forecast_sigma_s=900.0) if stoch else {}
    port_params, ref_params = _params(**kwargs)
    want = ref_pk._score_numpy(batch, ref_params)
    got = _port_dest(batch, port_params)
    np.testing.assert_array_equal(got, want)
    k = batch.n_jobs[0]
    assert (got[0, :k] == expect).all(), (case, got[0, :k], expect)
    assert (got[0, k:] == -1).all()  # padded rows never move


def test_padded_sites_never_win():
    """A real site that is worse than nothing still loses to 'stay', and
    the padded columns (W 0, bw 0) never appear as destinations."""
    batch = _batch([0.0, 100.0], [0.0, 2e9])
    got = _port_dest(batch, _params()[0])
    assert (got == -1).all()


def test_cpu_dispatch_takes_plain_version_without_launch():
    batch, _ = HAND_CASES["tie_equal_tt_lowest_sid"]
    before = ops.launch_counts()["decide_dest"]
    _port_dest(batch, _params()[0])
    assert ops.launch_counts()["decide_dest"] == before


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_inputs():
    batch, _ = HAND_CASES["tie_equal_tt_lowest_sid"]
    jobs, sites = (torch.from_numpy(a) for a in pk.pack_batch(batch))
    bw = torch.from_numpy(batch.bw)
    scalars = pk.kernel_scalars(_params()[0])
    with pytest.raises(ValueError, match="CUDA"):
        dc.decide_dest_cuda(jobs, sites, bw, **scalars)
    with pytest.raises(ValueError, match="float64"):
        ops.decide_dest(jobs.float(), sites, bw, **scalars)
    with pytest.raises(ValueError, match="shape"):
        ops.decide_dest(jobs[:, :4], sites, bw, **scalars)


# ---------------------------------------------------------------------------
# the policy end to end on the CPU: port decide == reference decide
# ---------------------------------------------------------------------------


def _state(mod, seed, t=1.7 * HOUR):
    """tests.test_vectorized.random_state without a forecast, built from
    either package's state module."""
    rng = np.random.default_rng(seed)
    n_sites = int(rng.integers(2, 6))
    sites = []
    for s in range(n_sites):
        green = bool(rng.random() < 0.5)
        sites.append(mod.SiteView(
            sid=s, slots=int(rng.integers(1, 5)), busy=int(rng.integers(0, 5)),
            queued=int(rng.integers(0, 4)), renewable_active=green,
            window_remaining_s=float(rng.uniform(0, 9 * HOUR)) if green else 0.0,
            incoming=int(rng.integers(0, 2)),
            next_window_start_s=(t + float(rng.uniform(0, 9 * HOUR))
                                 if rng.random() < 0.8 else float("inf"))))
    jobs = []
    for j in range(int(rng.integers(0, 14))):
        jobs.append(mod.JobView(
            jid=j, site=int(rng.integers(0, n_sites)),
            ckpt_bytes=float(rng.uniform(0.1, 400)) * GB,
            remaining_compute_s=float(rng.uniform(600, 24 * HOUR)),
            state=("queued", "running", "paused")[int(rng.integers(0, 3))],
            eligible=bool(rng.random() < 0.8)))
    transfers = tuple(
        (int(rng.integers(0, n_sites)), int(rng.integers(0, n_sites)))
        for _ in range(int(rng.integers(0, 3))))
    return mod.ClusterState.build(t, jobs, sites, nic_bps=2e9, transfers=transfers)


def _plain(actions):
    return [(type(a).__name__, dataclasses.astuple(a)) for a in actions]


@pytest.mark.parametrize("seed", range(6))
def test_port_decide_batch_matches_reference(seed):
    """decide and decide_batch of the port's policy on the CPU emit the
    reference policy's Action lists (and the port's scalar oracle's)."""
    ref_states = [_state(ref_state, seed * 31 + i) for i in range(6)]
    port_states = [_state(port_state, seed * 31 + i) for i in range(6)]
    ref_pol = RefFeasibilityAware()
    pol = FeasibilityAwarePolicy(device="cpu")
    want = [_plain(ref_pol.decide(s)) for s in ref_states]
    assert [_plain(a) for a in pol.decide_batch(port_states)] == want
    assert [_plain(pol.decide(s)) for s in port_states] == want
    assert [_plain(pol.decide_scalar(s)) for s in port_states] == want
