"""The port's synthetic data stream against the JAX package's: the same
arrays, element for element, for every (seed, step)."""
import numpy as np
import pytest

from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro_torch.data.pipeline import SyntheticLMDataset


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 17), (5, 18), (123, 4096)])
def test_batches_identical_to_reference(seed, step):
    args = dict(vocab_size=1000, seq_len=32, global_batch=4, seed=seed)
    got, want = SyntheticLMDataset(**args).batch(step), JDataset(**args).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_learnable_structure_and_shift():
    ds = SyntheticLMDataset(1000, 256, 8, seed=0, p_noise=0.1)
    b = ds.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    frac = ((ds.a * b["tokens"] + ds.b) % ds.vocab_size == b["labels"]).mean()
    assert 0.85 <= frac <= 0.95
