"""The port's WAN water-filling against the reference's, and its end on a
subnormal capacity.

``WanTopology.shared_rates(sharing="waterfill")`` of both packages on the
same seeded random profiles (per-site asymmetric NICs, per-link caps with
uncapped and cut links, fabric or per-link brownouts, one-relay paths),
bit for bit.  On a link of 4.94e-324 Gbit/s (a subnormal rate in bits/s)
the reference's loop never ends; the port's returns, which the test holds
with a time limit of its own: the call runs in a subprocess that is killed
when the limit passes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SUBNORMAL_GBPS = 4.94e-324
TIME_LIMIT_S = 60


def _profile_kw(rng: np.random.Generator, n: int) -> dict:
    def gbps():
        return tuple(float(v) for v in rng.uniform(0.1, 100.0, n))

    def link(s, d):
        u = rng.random()
        if u < 0.3 or s == d:
            return None  # NIC-limited
        if u < 0.4:
            return 0.0  # cut
        return float(rng.uniform(0.0, 50.0))

    return dict(nic_gbps=gbps(), nic_in_gbps=gbps(),
                link_gbps=tuple(tuple(link(s, d) for d in range(n)) for s in range(n)),
                hourly_degrade_prob=float(rng.choice([0.0, 0.5])), degraded_gbps=0.5,
                brownout_scope=str(rng.choice(["fabric", "per-link"])),
                sharing="waterfill", multi_hop=bool(rng.random() < 0.5))


@pytest.mark.parametrize("seed", range(8))
def test_waterfill_rates_equal_the_reference_bit_for_bit(seed):
    from repro.core.wan import WanProfile as JWanProfile

    from repro_torch.core.wan import WanProfile

    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(2, 7))
        kw = _profile_kw(rng, n)
        topo_seed = int(rng.integers(0, 6))
        ref = JWanProfile(**kw).build_topology(n, days=2, seed=topo_seed)
        port = WanProfile(**kw).build_topology(n, days=2, seed=topo_seed)
        pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
        flows = [pairs[i] for i in rng.integers(0, len(pairs), int(rng.integers(0, 13)))]
        t = float(rng.uniform(0.0, 2 * 24 * 3600.0))
        want = ref.shared_rates(flows, t)
        got = port.shared_rates(flows, t)
        assert got.dtype == want.dtype and np.array_equal(got, want), (kw, flows, t)
        np.testing.assert_array_equal(port.advertised_matrix(t, flows),
                                      ref.advertised_matrix(t, flows))


_SUBNORMAL = f"""
from repro_torch.core.wan import WanProfile
link = ((None, {SUBNORMAL_GBPS!r}, None), (1.0, None, None), (None, None, None))
topo = WanProfile(gbps=10.0, link_gbps=link, sharing="waterfill").build_topology(3, days=1,
                                                                                  seed=0)
print(repr(float(topo.link_bps[0, 1])))
print([float(r) for r in topo.shared_rates([(0, 1), (0, 1), (0, 1), (0, 2), (1, 0), (2, 1)])])
"""


def test_waterfill_returns_on_a_subnormal_capacity():
    """Three flows share a 4.94e-315 b/s link (1e9 of the least subnormal,
    which a third of does not divide) beside three others: the loop ends
    within the limit, the link's flows freeze at what it holds and the
    rest share their NICs as max-min says."""
    env = dict(os.environ, PYTHONPATH=SRC)
    try:
        done = subprocess.run([sys.executable, "-c", _SUBNORMAL], env=env, capture_output=True,
                              text=True, timeout=TIME_LIMIT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"shared_rates did not return within {TIME_LIMIT_S} s")
    assert done.returncode == 0, done.stderr[-3000:]
    link_line, rates_line = done.stdout.strip().splitlines()
    link = float(link_line)
    assert 0.0 < link < np.finfo(np.float64).tiny  # subnormal
    rates = eval(rates_line)  # a printed list of floats
    assert len(rates) == 6 and all(r >= 0.0 for r in rates)
    assert 0.0 < sum(rates[:3]) <= link
    # 0 -> 2 holds site 0's egress but what the subnormal link took; 1 -> 0
    # is capped by its 1 Gbit/s link; 2 -> 1 fills site 1's ingress
    assert rates[3] == pytest.approx(10e9)
    assert rates[4] == pytest.approx(1e9)
    assert rates[5] == pytest.approx(10e9)
