"""The whole serving slice on the CPU at the reduced size, through
chip_smoke.run_slice (the sequence the card runs at full width), against the
same sequence in the JAX package: site A prefill and greedy decode, int8
checkpoint, feasibility gate, migrate_job, restore at site B, prefill and
decode there.  Same weights (the JAX init carried across) and prompts."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.core import feasibility as jfz
from repro.core.migration import migrate_job as jmigrate_job
from repro.launch.serve import greedy_decode as jgreedy_decode
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import flatten_with_paths, params_from_numpy
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.kernels import ops

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

TOL = 1e-5  # float32 on both sides, sums in different orders
B, P, NEW = 3, 12, 8


def test_serving_slice_matches_reference(tmp_path):
    jcfg = jget_config("micro-lm").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompts = SyntheticLMDataset(jcfg.vocab_size, P, B, seed=1).batch(0)["tokens"]

    # --- the JAX package ---
    jlogits_a, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(prompts)})
    jtokens_a = jgreedy_decode(jmodel, jparams, jnp.asarray(prompts), NEW, P + NEW)
    jm = JManager(str(tmp_path / "jax" / "siteA"), job=jcfg.name, mode="int8")
    jm.save(0, jparams)
    jverdict = jfz.evaluate(jm.latest_bytes, chip_smoke.BANDWIDTH_BPS, chip_smoke.WINDOW_S)
    jdst, jrep = jmigrate_job(jm, str(tmp_path / "jax" / "siteB"),
                              bandwidth_bps=chip_smoke.BANDWIDTH_BPS, window_s=chip_smoke.WINDOW_S)
    jparams_b, _ = jdst.restore(jparams)
    jlogits_b, _ = jmodel.forward(jparams_b, {"tokens": jnp.asarray(prompts)})
    jtokens_b = jgreedy_decode(jmodel, jparams_b, jnp.asarray(prompts), NEW, P + NEW)

    # --- the port ---
    cfg = get_config("micro-lm").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ops.reset_launch_counts()
    res = chip_smoke.run_slice(cfg, params, torch.from_numpy(prompts).long(), str(tmp_path / "torch"),
                               max_new=NEW, device="cpu")
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bf16": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_bf16": 0,
                                   "quantize_int8": 0, "dequantize_int8": 0, "decide_dest": 0}

    np.testing.assert_allclose(res.logits_a.numpy(), np.asarray(jlogits_a), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(res.tokens_a.numpy(), np.asarray(jtokens_a))
    assert res.manager.export_bytes() == jm.export_bytes()
    assert res.nbytes == jm.latest_bytes
    for got, want in zip(res.verdict, jverdict):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert bool(res.verdict.feasible) and int(res.verdict.workload_class) == 0
    a, b = dataclasses.asdict(res.report), dataclasses.asdict(jrep)
    a.pop("t_serialize_s"), b.pop("t_serialize_s")
    assert a == b
    jb = dict(("/".join(str(k.key) for k in p), np.asarray(x))
              for p, x in jax.tree_util.tree_flatten_with_path(jparams_b)[0])
    for path, x in flatten_with_paths(res.params_b):
        np.testing.assert_array_equal(x.numpy(), jb["/".join(path)])
    np.testing.assert_allclose(res.logits_b.numpy(), np.asarray(jlogits_b), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(res.tokens_b.numpy(), np.asarray(jtokens_b))


def test_bf16_prefill_matches_reference():
    """chip_smoke.run_bf16_prefill (micro-lm served in bf16) on the CPU
    against the JAX package's forward with the same weights cast to bf16
    and its config's dtype set to bf16: bf16 on both sides, rounded in
    different places, so chip_smoke's bf16 model tolerance."""
    jcfg = dataclasses.replace(jget_config("micro-lm").reduced(), dtype="bfloat16")
    jparams = jbuild_model(jget_config("micro-lm").reduced()).init(jax.random.PRNGKey(0))
    prompts = SyntheticLMDataset(jcfg.vocab_size, P, B, seed=1).batch(0)["tokens"]
    jparams16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    jlogits, _ = jbuild_model(jcfg).forward(jparams16, {"tokens": jnp.asarray(prompts)})

    cfg = get_config("micro-lm").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ops.reset_launch_counts()
    logits, _ = chip_smoke.run_bf16_prefill(cfg, params, torch.from_numpy(prompts).long(),
                                            device="cpu")
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bf16": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_bf16": 0,
                                   "quantize_int8": 0, "dequantize_int8": 0, "decide_dest": 0}
    assert logits.dtype == torch.bfloat16
    want = np.asarray(jlogits.astype(jnp.float32))
    np.testing.assert_allclose(logits.float().numpy(), want, atol=chip_smoke.MODEL_BF16_TOL,
                               rtol=chip_smoke.MODEL_BF16_TOL)
