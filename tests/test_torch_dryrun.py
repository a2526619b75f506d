"""The port's mesh-lowering dry-run on the CPU.

* ``TraceRecorder`` on hand-built functional collectives counts the bytes
  of the reference's ``test_collective_bytes_parse`` cases (output shards:
  bytes received per device), and ordinary ops go to ``bytes``, not to a
  collective kind.
* K1's custom ops trace on fake tensors with no launch, and
  ``FlopCounterMode`` counts them by their formula (checked against a brute
  count of the visible pairs).
* One ``lower_cell`` decode cell, traced with ``device="cpu"`` in a process
  of its own (the fake world is process-global): status OK, the argument
  bytes equal to the spec-implied ones, the peak under the card's memory.
* Which cells extrapolate over the length (xlstm's train and prefill), and
  that the extrapolation from the second and third mLSTM chunk is exact on
  a traced xLSTM train step.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import (
    EXTRAPOLATE_LENGTHS, HBM_BW, NVLINK_BW, PEAK_FLOPS, TraceRecorder, _affine, _extrapolated)
from repro_torch.models import mamba, xlstm
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.train_step import TrainStepConfig, make_train_step

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_collective_recorder_counts_reference_cases():
    fake = FakeTensorMode()
    with fake:
        ag_in = torch.empty(1, 4096, 5120, dtype=torch.bfloat16)
        rs_in = torch.empty(1024, 128)
        ar_in = torch.empty(1024)
        a2a_in = torch.empty(16, 32)
        d = torch.empty(4)
    rec = TraceRecorder(fake)
    c10d = torch.ops._c10d_functional
    with rec:
        c10d.all_gather_into_tensor(ag_in, 16, "g")
        c10d.reduce_scatter_tensor(rs_in, "sum", 16, "g")
        c10d.all_reduce(ar_in, "sum", "g")
        c10d.all_to_all_single(a2a_in, [8, 8], [8, 8], "g")
        d + d
    assert rec.collectives == {"all-gather": 16 * 4096 * 5120 * 2, "reduce-scatter": 64 * 128 * 4,
                               "all-reduce": 1024 * 4, "all-to-all": 2 * 8 * 32 * 4}
    assert rec.bytes == 3 * 4 * 4  # the add: two operands and its result
    assert rec.flops == 0


def test_recorder_flops_bytes_and_peak_of_a_matmul():
    fake = FakeTensorMode()
    with fake:
        a, b = torch.empty(64, 32), torch.empty(32, 16)
    rec = TraceRecorder(fake)
    with rec:
        c = a @ b
        c.t()  # a view: no bytes
        del c
        e = a.sum()
    assert rec.flops == 2 * 64 * 32 * 16
    assert rec.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 + (64 * 32 + 1) * 4
    assert rec.peak == 64 * 16 * 4 and rec.live == e.numel() * 4


@pytest.mark.parametrize("s,mask,window", [(7, "causal", 0), (64, "window", 16), (33, "full", 0),
                                           (9, "window", 20), (128, "causal", 0)])
def test_visible_pairs_closed_form(s, mask, window):
    q = torch.arange(s)[:, None]
    k = torch.arange(s)[None, :]
    ok = torch.ones(s, s, dtype=torch.bool)
    if mask != "full":
        ok &= k <= q
    if mask == "window" and window > 0:
        ok &= q - k < window
    assert fa.visible_pairs(s, mask, window) == int(ok.sum())


def test_k1_custom_ops_trace_fake_tensors_without_launch():
    ops.reset_launch_counts()
    with FakeTensorMode():
        q, k = torch.empty(2, 96, 8, 64), torch.empty(2, 96, 2, 64)
        with FlopCounterMode(display=False) as fc:
            o, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, k, "window", 32, 0.0, True)
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(q, k, k, o, lse, o, "window",
                                                                    32, 0.0)
    pairs = fa.visible_pairs(96, "window", 32)
    assert fc.get_total_flops() == (4 + 10) * 2 * 8 * 64 * pairs
    assert o.shape == q.shape and lse.shape == (2, 8, 96) and dk.shape == k.shape
    assert not any(ops.launch_counts().values())


def test_roofline_constants_are_the_h100_spec():
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)


def test_lower_cell_decode_on_the_cpu(tmp_path):
    code = ("import json\n"
            "from repro_torch.launch.dryrun import lower_cell\n"
            "r = lower_cell('qwen3-1.7b', 'decode_32k', device='cpu', save_artifact=False)\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "OK" and rec["n_chips"] == 256 and rec["device"] == "cpu"
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["argument_spec_bytes"] > 0
    assert mem["argument_bytes"] < mem["peak_bytes"] < 80e9
    assert rec["hlo_flops_per_device"] > 0 and rec["collective_bytes_per_device"] > 0
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                       "collective-permute"}


def test_only_attention_free_train_and_prefill_cells_extrapolate():
    """xlstm-1.3b's train and prefill cells trace at two lengths (no
    attention); every other cell, and every decode cell, is traced at its
    own length.  The lengths are the second and third whole mLSTM chunk."""
    got = {(a, sh) for a in ("xlstm-1.3b", "jamba-v0.1-52b", "qwen3-1.7b", "whisper-tiny")
           for sh in get_config(a).shapes() if _extrapolated(get_config(a), SHAPES[sh])}
    assert got == {("xlstm-1.3b", "train_4k"), ("xlstm-1.3b", "prefill_32k")}
    assert EXTRAPOLATE_LENGTHS == (2 * xlstm.CHUNK, 3 * xlstm.CHUNK)


def _xlstm_step_counts(kind: str, n: int, arch: str = "xlstm-1.3b") -> dict:
    """The recorder's counts of one train step of a reduced one-block model
    of ``arch`` (its block ``kind``) over ``n`` tokens, on fake tensors."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=1, block_pattern=(kind,))
    model = build_model(cfg)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        params = model.init(0, device="cpu")
        opt = init_opt_state(params)
        tokens = torch.zeros(2, n, dtype=torch.int32)
    rec = TraceRecorder(fake)
    with rec:
        make_train_step(model, TrainStepConfig(remat_policy="full"))(
            params, opt, {"tokens": tokens, "labels": tokens})
    return {"flops": rec.flops, "bytes": rec.bytes, "temp_peak_bytes": rec.peak,
            "collectives": {}}


def _line(c: dict, n1: int, n2: int, n: int, keys) -> bool:
    """Whether the counts at ``n`` lie on the line through ``n1`` and ``n2``."""
    got = _affine(c[n1], c[n2], n1, n2, n)
    return all(got[k] == c[n][k] for k in keys)


def test_mlstm_counts_are_affine_from_the_second_chunk(monkeypatch):
    """A traced train step of an mLSTM block: from the second chunk on,
    its FLOPs and bytes grow by the same amount a chunk, so the
    extrapolation from the second and third chunk is exact further on; the
    first chunk is off that line (its carry has no gradient), and so is a
    length inside a chunk (the intra-chunk work is quadratic).  The peak is
    the larger of a constant and such a line: on the line once the line is
    above.  The chunk is cut to 16 tokens to keep the trace short."""
    monkeypatch.setattr(xlstm, "CHUNK", 16)
    c = {n: _xlstm_step_counts("mlstm", n) for n in (8, 16, 32, 48, 64, 80, 96)}
    work = ("flops", "bytes")
    assert _line(c, 32, 48, 64, work) and _line(c, 32, 48, 96, work)
    assert not _line(c, 16, 32, 96, work) and not _line(c, 8, 16, 96, work)
    assert c[48]["temp_peak_bytes"] < c[64]["temp_peak_bytes"]
    assert _line(c, 64, 80, 96, ("temp_peak_bytes",))


def test_mamba_counts_are_affine_from_the_second_chunk(monkeypatch):
    """A traced train step of a reduced jamba's Mamba block: from the
    second chunk on its FLOPs and bytes grow by the same amount a chunk.
    Each chunk's scan is recomputed in the backward, so its (b, l, d_in, N)
    passes are not kept from chunk to chunk: the peak grows by less than
    two such tensors a chunk (the carried state and the sequence-wide
    activations), where the whole doubling scan of every chunk (log2(l)
    passes of two tensors) was kept before.  The chunk is cut to 16
    tokens."""
    monkeypatch.setattr(mamba, "CHUNK", 16)
    c = {n: _xlstm_step_counts("mamba", n, "jamba-v0.1-52b") for n in (16, 32, 48, 64, 96)}
    work = ("flops", "bytes")
    assert _line(c, 32, 48, 64, work) and _line(c, 32, 48, 96, work)
    cfg = get_config("jamba-v0.1-52b").reduced()
    one_pass = 2 * 16 * cfg.mamba_expand * cfg.d_model * cfg.mamba_d_state * 4  # f32, b = 2
    assert (c[96]["temp_peak_bytes"] - c[64]["temp_peak_bytes"]) / 2 < 2 * one_pass


def test_slstm_counts_are_affine_in_the_length():
    """The sLSTM runs token by token: every count of its traced train step,
    the peak included, is affine in the length."""
    c = {n: _xlstm_step_counts("slstm", n) for n in (4, 8, 12)}
    assert _line(c, 4, 8, 12, ("flops", "bytes", "temp_peak_bytes"))
