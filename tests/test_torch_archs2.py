"""What the port added for qwen2.5-32b, qwen1.5-32b, phi3.5-moe-42b-a6.6b
and qwen2-vl-7b beside the parity of the models themselves (which
tests/test_torch_archs.py holds with the other attention-family
architectures): M-RoPE against the JAX package's, the serve launcher's
refusal of embeddings-input archs, ``init_lm``'s in-place draw, and
chip_smoke's ``[archs2]`` phase rehearsed on the CPU.

M-RoPE is held at 1e-6: the same float32 rotations on both sides.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rope as jrope
from repro_torch.configs import get_config
from repro_torch.convert import flatten_with_paths
from repro_torch.launch import serve as port_serve
from repro_torch.models import rope, transformer as tfm
from repro_torch.models.model import build_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import mrope_positions  # noqa: E402


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def _rope_inputs(seed=0, b=2, s=40, h=3, hd=16):
    x = np.random.default_rng(seed).standard_normal((b, s, h, hd)).astype(np.float32)
    return x, mrope_positions(b, 4, 4, s - 16).numpy().astype(np.int32)


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_reference_on_distinct_streams(sections, hd):
    x, pos = _rope_inputs(hd=hd)
    assert len({tuple(pos[0, -1]), tuple(pos[0, 5])}) == 2 and (pos[..., 1] != pos[..., 2]).any()
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    via = rope.apply_positional(torch.from_numpy(x), torch.from_numpy(pos), "mrope", 1e6, sections)
    assert torch.equal(via, got)


def test_mrope_text_fallback_is_rope_and_section_order_matters():
    """2-D positions (one stream thrice) give plain RoPE exactly, so a test
    fed them cannot see the sections; on distinct streams a swapped
    section order differs."""
    x, pos = _rope_inputs()
    xt = torch.from_numpy(x)
    text = torch.from_numpy(pos[..., 0])
    fallback = rope.apply_positional(xt, text, "mrope", 1e6, (2, 3, 3))
    assert torch.equal(fallback, rope.apply_rope(xt, text, 1e6))
    a = rope.apply_mrope(xt, torch.from_numpy(pos), 1e6, (2, 3, 3))
    b = rope.apply_mrope(xt, torch.from_numpy(pos), 1e6, (3, 3, 2))
    assert float((a - b).abs().max()) > 0.1
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(xt, torch.from_numpy(pos), 1e6, (2, 3, 2))


def test_mrope_positions_grid_then_text():
    pos = mrope_positions(2, 3, 4, 5)
    assert pos.shape == (2, 17, 3)
    grid = pos[0, :12]
    assert grid[:, 0].tolist() == [0] * 12
    assert grid[:, 1].tolist() == [r for r in range(3) for _ in range(4)]
    assert grid[:, 2].tolist() == list(range(4)) * 3
    text = pos[0, 12:]
    assert text.tolist() == [[4 + i] * 3 for i in range(5)]
    assert torch.equal(pos[0], pos[1])


# ---------------------------------------------------------------------------
# The serve launcher
# ---------------------------------------------------------------------------


def test_serve_refuses_embedding_input_arch_as_the_reference():
    from repro.launch import serve as ref_serve

    argv = ["--arch", "qwen2-vl-7b", "--smoke"]
    with pytest.raises(SystemExit, match="token-input decoder-only") as want:
        ref_serve.main(argv)
    with pytest.raises(SystemExit) as got:
        port_serve.main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_serve_qwen2_5_smoke_completes(capsys):
    assert port_serve.main(["--arch", "qwen2.5-32b", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] generated 96 tokens" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# The in-place init
# ---------------------------------------------------------------------------


def _init_by_stacking(cfg, seed):
    """init_lm as it drew before: every group's tree from the same
    generator, then stacked."""
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    from repro_torch.models.layers import init_embed, init_norm

    params = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dt, "cpu")}
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": init_embed(gen, cfg.d_model, cfg.vocab_size, dt, "cpu")["table"]}
    trees = [{f"b{i}": tfm.init_block(gen, cfg, tfm._is_moe_pos(cfg, i), "cpu")
              for i in range(len(cfg.block_pattern))} for _ in range(cfg.num_groups)]

    def stack(ts):
        return {k: stack([t[k] for t in ts]) for k in ts[0]} if isinstance(ts[0], dict) \
            else torch.stack(ts)

    params["groups"] = stack(trees)
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_type, dt, "cpu")
    return params


@pytest.mark.parametrize("arch,layers,dtype", [
    ("micro-lm", 0, "float32"), ("granite-moe-1b-a400m", 3, "bfloat16"),
    ("qwen2.5-32b", 3, "float32"), ("gemma2-2b", 4, "bfloat16")])
def test_init_in_place_is_bit_identical_to_stacking(arch, layers, dtype):
    """The stacked leaves written group by group hold the same bits as
    stacking per-group trees from the same seeded generator: no seed's
    params change."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers * len(cfg.block_pattern))
    got = build_model(cfg).init(5, device="cpu")
    want = _init_by_stacking(cfg, 5)
    pairs = list(zip(flatten_with_paths(got), flatten_with_paths(want)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    for (path, x), (_, y) in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), path
    assert got["groups"]["b0"]["attn"]["wq"].shape[0] == cfg.num_groups
    assert all(x.is_contiguous() for _, x in flatten_with_paths(got["groups"]))


# ---------------------------------------------------------------------------
# chip_smoke's [archs2] phase
# ---------------------------------------------------------------------------


def test_chip_smoke_archs2_phase_on_cpu(monkeypatch, tmp_path):
    """chip_smoke's [archs2] phase, the sequence the card runs at full
    width, on the CPU at the reduced sizes in bf16 with the kernels' plain
    versions standing in (tests/test_torch_archs.py's use_plain_stand_ins):
    phi3.5-moe served at 1 of its 2 layers, the float32 decode on a copy
    of the first group (qwen2-vl's whole model), and K1 checked at GQA
    groups 5, 1, 4 and 7, so every count the phase derives and every check
    it makes runs here."""
    from test_torch_archs import use_plain_stand_ins

    chip_smoke = use_plain_stand_ins(monkeypatch, tmp_path)
    for name, value in (("ARCH2_LAYERS", {"phi3.5-moe-42b-a6.6b": 1}), ("ARCH2_F32_GROUPS", 1),
                        ("ARCH_PREFILL_DEFAULT", (2, 24)), ("ARCH2_GRID", (3, 4)),
                        ("ARCH2_SMALL_GRID", (2, 3)), ("ARCH_CARD_CPU_SEQ", 16),
                        ("ARCH2_CARD_CPU_SEQ", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "ARCH_FLASH_CASES", {
        "qwen2.5-32b": (2, 24, 24, 10, 2, 16, "causal", 0, 0.0),
        "qwen1.5-32b": (2, 24, 24, 4, 4, 16, "causal", 0, 0.0),
        "phi3.5-moe-42b-a6.6b": (2, 24, 24, 8, 2, 16, "causal", 0, 0.0),
        "qwen2-vl-7b": (1, 24, 24, 14, 2, 16, "causal", 0, 0.0)})
    for name, fn in (("memory_allocated", lambda *a: 0), ("max_memory_allocated", lambda *a: 0),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("mem_get_info", lambda *a: (1, 1))):
        monkeypatch.setattr(torch.cuda, name, fn)
    total = chip_smoke.phase_archs2(torch.device("cpu"))
    # per arch, at its served depth L: 3 prefills (two, one profiled); at
    # one group's depth its forward, a step (2 x its layer of K1 under
    # remat "full", 1 of the backward), the prefill its bf16 decode is held
    # to and 2 of the checkpoint lifecycle; in float32 the prefill of its
    # decode check (1 group, qwen2-vl 2), and phi3.5-moe's float32 step
    layers = {"qwen2.5-32b": 2, "qwen1.5-32b": 2, "phi3.5-moe-42b-a6.6b": 1, "qwen2-vl-7b": 2}
    assert total["flash_attention_bf16"] == sum(3 * n + 6 for n in layers.values())
    assert total["flash_attention_bwd_bf16"] == 4
    assert total["flash_attention"] == 1 + 1 + 1 + 2 + 2
    assert total["flash_attention_bwd"] == 1
    assert total["quantize_int8"] == total["dequantize_int8"] == total["decide_dest"] == 0
