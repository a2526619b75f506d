"""chip_smoke's [archs3] phase (jamba-v0.1-52b, xlstm-1.3b, whisper-tiny),
the sequence the card runs at full width, on the CPU at the reduced sizes
in bf16 with the kernels' plain versions standing in
(tests/test_torch_archs.py's use_plain_stand_ins), so every launch count
the phase derives and every check it makes runs here."""
import pytest
import torch

from test_torch_archs import use_plain_stand_ins


@pytest.fixture
def few_threads():
    """The phase runs many small ops: on a few threads they do not wait on
    the pool the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_archs3_phase_on_cpu(monkeypatch, tmp_path, few_threads):
    """jamba served at 1 of its 2 reduced groups; xlstm's lifecycle at 4
    steps (preempted at 2) on 2 x 16 tokens; K1 at reduced shapes, the
    encoder's ragged (27 keys)."""
    chip_smoke = use_plain_stand_ins(monkeypatch, tmp_path)
    for name, value in (("ARCH3_LAYERS", {"jamba-v0.1-52b": 8}), ("ARCH_PREFILL_DEFAULT", (2, 24)),
                        ("ARCH_PROMPT", (2, 8)), ("ARCH_NEW", 4), ("ARCH2_CARD_CPU_SEQ", 16),
                        ("XLSTM_LIFE_SEQ", 16), ("XLSTM_LIFE_STEPS", 4), ("XLSTM_LIFE_PREEMPT", 2),
                        ("XLSTM_LIFE_SAVE_EVERY", 5), ("SLSTM_TIME_SEQ", 16), ("MAMBA_SEQ", 264),
                        ("MAMBA_PREFILL", 256)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "ARCH_FLASH_CASES", {
        "jamba-v0.1-52b": (2, 24, 24, 8, 2, 16, "causal", 0, 0.0),
        "whisper-tiny encoder": (2, 27, 27, 4, 4, 16, "full", 0, 0.0),
        "whisper-tiny decoder": (2, 16, 16, 4, 4, 16, "causal", 0, 0.0)})
    for name, fn in (("memory_allocated", lambda *a: 0), ("max_memory_allocated", lambda *a: 0),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("mem_get_info", lambda *a: (1, 1)), ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    total = chip_smoke.phase_archs3(torch.device("cpu"))
    jamba = chip_smoke.get_config("jamba-v0.1-52b")
    whisper = chip_smoke.get_config("whisper-tiny")
    enc, dec = whisper.encoder_layers, whisper.num_layers
    # jamba served at one group (one attention layer): 3 prefills; block b4
    # (attention) card vs CPU: K1 and its backward once.  whisper: 2
    # encodes and the decode cache's encode; card vs CPU its forward (enc +
    # dec layers) and a step (twice under remat "full", the backward once);
    # in float32 its decode cache's encode and its forward, and the
    # forward the card-vs-CPU check compares with
    assert total["flash_attention_bf16"] == 3 * 1 + 1 + 3 * enc + (enc + dec) + 2 * (enc + dec)
    assert total["flash_attention_bwd_bf16"] == 1 + (enc + dec)
    assert total["flash_attention"] == enc + (enc + dec)
    assert total["flash_attention_bwd"] == 0
    # xlstm's sLSTM block's params in int8 (16 leaves); whisper's int8
    # checkpoint of its params
    n_whisper = len(chip_smoke.flatten_with_paths(
        chip_smoke.build_model(whisper).init(0, device="cpu")))
    assert total["quantize_int8"] == total["dequantize_int8"] == 16 + n_whisper
    assert total["decide_dest"] == 0
    assert jamba.num_layers == 16
