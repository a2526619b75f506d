#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which raises on failure:
  1. device  -- a CUDA card is required; print its name and power limit;
  2. build   -- compile the hand-written kernels from src/repro_torch/csrc;
  3. kernels -- hold each kernel against its plain PyTorch version on the
                card, at the serving slice's shapes and more, and time both;
  4. slice   -- the serving slice at micro-lm's full width, through the
                port's own entry points, with the launch counters set to 0
                just before it and read just after:
                site A prefill (Model.forward) and greedy decode, an int8
                GRNCKPT1 checkpoint, the feasibility gate on the measured
                bytes, migrate_job to site B, restore there, prefill and
                decode again;
  5. checks  -- the slice's outputs against the plain path on the CPU;
  6. profile -- device busy share and top kernels of prefill and decode.
Then one JSON line of per-kernel numbers, and last the ok line.  Nothing
runs on the CPU in place of the card: without a card the script exits 1.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import serializer as ser  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import flatten_with_paths, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import feasibility  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.core.migration import migrate_job  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.quantize import dequantize_int8_cuda, quantize_int8_cuda  # noqa: E402
from repro_torch.launch.serve import greedy_decode  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

# The slice: 8 requests of 512 prompt tokens (the synthetic LM stream), 64
# new tokens each.
BATCH, PROMPT, NEW = 8, 512, 64
BANDWIDTH_BPS, WINDOW_S = 10e9, 2.5 * 3600
# Kernel vs plain version, both float32 on the card: they sum the hd-term
# dot products and the softmax-weighted sums over keys in different orders
# (each ~1e-7 relative) and expf differs by <= 2 ulp, so 1e-5 abs and rel.
FLASH_TOL = 1e-5
# Port on the card vs the plain path on the CPU, whole model: float32
# matmuls on both sides in different summation orders over 8 layers.
MODEL_TOL = 1e-4
# Prefill vs step-by-step decode, the JAX package's own tolerance
# (tests/test_models.py::test_prefill_decode_equivalence).
DECODE_TOL = 2e-4

# (b, s, t, nh, nkv, hd, mask, window, softcap): the slice's shape, the
# float32 rows of tests/test_kernels.py::SWEEP, the reduced model's hd 16,
# and ragged shapes that divide no tile.
FLASH_CASES = [
    (BATCH, PROMPT, PROMPT, 6, 6, 64, "causal", 0, 0.0),
    (2, 128, 128, 4, 4, 64, "causal", 0, 0.0),
    (2, 256, 256, 4, 2, 64, "causal", 0, 0.0),
    (2, 256, 256, 8, 1, 128, "causal", 0, 0.0),
    (2, 512, 512, 4, 2, 128, "window", 128, 0.0),
    (2, 256, 256, 2, 2, 256, "window", 4096, 0.0),
    (2, 128, 128, 4, 4, 64, "full", 0, 0.0),
    (2, 256, 256, 8, 4, 64, "causal", 0, 50.0),
    (2, 12, 12, 4, 2, 16, "causal", 0, 0.0),
    (1, 200, 200, 4, 2, 32, "causal", 0, 0.0),
    (2, 77, 77, 4, 2, 16, "window", 16, 0.0),
    (1, 100, 300, 2, 1, 128, "full", 0, 0.0),
]
RAGGED_GROUPS = (1, 3, 100, 1001)

KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124"),
    "quantize_int8": dict(
        route="cuda", source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:44"),
    "dequantize_int8": dict(
        route="cuda", source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:67"),
}
# H100 SXM data sheet: HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` CUDA-event-timed calls,
    after ``warmup``.  A spin kernel is queued ahead of each timed call, so
    the host has enqueued all of ``fn``'s launches before the device reaches
    them: the events time the device's work, not the host's launch pace
    (which the slice's wall-clock numbers show).  If the device reached the
    start event before the host returned, the spin was too short: the call
    is timed again with a spin twice as long, up to ~0.5 s of spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, spin = [], 1 << 22
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end))
        elif spin >= 1 << 30:  # ~0.5 s of spin: fn itself waits for the device
            raise RuntimeError("timed call synchronises with the device; cannot time it")
        else:
            spin *= 2
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(gen, shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device)


# ---------------------------------------------------------------------------
# The serving slice (also run on the CPU by tests/test_torch_slice.py)
# ---------------------------------------------------------------------------


@dataclass
class SliceResult:
    logits_a: torch.Tensor
    tokens_a: torch.Tensor
    logits_b: torch.Tensor
    tokens_b: torch.Tensor
    params_b: dict
    manager: CheckpointManager
    nbytes: int
    verdict: feasibility.FeasibilityVerdict
    report: object
    prefill_a_s: float
    decode_a_s: float
    save_s: float
    migrate_s: float
    restore_s: float
    prefill_b_s: float
    decode_b_s: float


def run_slice(cfg, params, prompts, workdir, *, max_new, device,
              bandwidth_bps=BANDWIDTH_BPS, window_s=WINDOW_S) -> SliceResult:
    """Serve at site A, int8-checkpoint, gate, migrate, restore and serve
    again at site B, through the port's entry points on ``device``."""
    dev = resolve(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model = build_model(cfg)
    cache_len = prompts.shape[1] + max_new
    clock = time.perf_counter

    def timed(fn):
        t0 = clock()
        out = fn()
        sync()
        return out, clock() - t0

    (logits_a, _), prefill_a = timed(lambda: model.forward(params, {"tokens": prompts}))
    tokens_a, decode_a = timed(lambda: greedy_decode(model, params, prompts, max_new, cache_len))
    mgr = CheckpointManager(os.path.join(workdir, "siteA"), job=cfg.name, mode="int8")
    _, save_s = timed(lambda: mgr.save(0, params))
    nbytes = mgr.latest_bytes
    verdict = feasibility.evaluate(nbytes, bandwidth_bps, window_s)
    if not bool(verdict.feasible):
        raise RuntimeError(f"feasibility gate refused {nbytes} B at {bandwidth_bps} b/s: {verdict}")
    (dst, report), migrate_s = timed(lambda: migrate_job(
        mgr, os.path.join(workdir, "siteB"), bandwidth_bps=bandwidth_bps, window_s=window_s))
    (params_b, _), restore_s = timed(lambda: dst.restore(params, device=dev))
    (logits_b, _), prefill_b = timed(lambda: model.forward(params_b, {"tokens": prompts}))
    tokens_b, decode_b = timed(lambda: greedy_decode(model, params_b, prompts, max_new, cache_len))
    return SliceResult(logits_a, tokens_a, logits_b, tokens_b, params_b, mgr, nbytes, verdict,
                       report, prefill_a, decode_a, save_s, migrate_s, restore_s, prefill_b,
                       decode_b)


# ---------------------------------------------------------------------------
# Phases on the card
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return name


def phase_build() -> None:
    t0 = time.time()
    path = _build.build()
    _build.load()
    log(f"[build] {path.name} ready in {time.time() - t0:.1f} s")
    log_file = _build.log_path(path)
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("built"):
                log(f"[build]   {line.strip()}")


def check_flash(dev, gen):
    worst = 0.0
    for b, s, t, nh, nkv, hd, mask, win, cap in FLASH_CASES:
        q = randn(gen, (b, s, nh, hd), dev)
        k = randn(gen, (b, t, nkv, hd), dev)
        v = randn(gen, (b, t, nkv, hd), dev)
        kw = dict(mask_kind=mask, window=win, attn_softcap=cap)
        got = flash_attention_cuda(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=FLASH_TOL, rtol=FLASH_TOL):
            raise RuntimeError(f"flash_attention {(b, s, t, nh, nkv, hd, mask, win, cap)}: "
                               f"max abs err {err} beyond {FLASH_TOL}")
        worst = max(worst, err)
    log(f"[kernels] flash_attention: {len(FLASH_CASES)} shapes within {FLASH_TOL} of the plain "
        f"version, max abs err {worst:.3e}")

    b, s, nh, hd = BATCH, PROMPT, 6, 64
    q, k, v = (randn(gen, (b, s, nh, hd), dev) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(lambda: flash_attention_cuda(q, k, v))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    pairs = b * nh * s * (s + 1) // 2  # causal (q, k) pairs this input needs
    b_ms, b_by = bound(4 * q.numel() * 4, 4 * hd * pairs)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def _ragged_inputs(gen, dev):
    xs = []
    for groups in RAGGED_GROUPS:
        x = randn(gen, (groups * 256,), dev, 3.0)
        if groups > 1:
            x[:256] = 0.0  # all-zero group: scale 1.0, codes 0
            # amax 127 gives scale 1.0 exactly, so x / scale lands on .5 ties
            ties = (torch.arange(256) % 254 - 127).float() + 0.5
            ties[0] = 127.0
            x[256:512] = ties.to(dev)
        xs.append(x)
    return xs


def check_quantize(dev, gen, leaves):
    flats = []
    for x in leaves:
        flat = x.reshape(-1).float()
        flats.append(torch.nn.functional.pad(flat, (0, (-flat.numel()) % 256)))
    cases = flats + _ragged_inputs(gen, dev)
    codes = []
    for x in cases:
        qk, sk = quantize_int8_cuda(x)
        qr, sr = ref.quantize_int8_ref(x)
        if not (torch.equal(qk, qr) and torch.equal(sk, sr)):
            raise RuntimeError(f"quantize_int8 differs from the plain version at n={x.numel()}: "
                               f"{int((qk != qr).sum())} codes, {int((sk != sr).sum())} scales")
        xk = dequantize_int8_cuda(qk, sk)
        if not torch.equal(xk, ref.dequantize_int8_ref(qk, sk)):
            raise RuntimeError(f"dequantize_int8 differs from the plain version at n={x.numel()}")
        codes.append((qk, sk))
    torch.cuda.synchronize()
    log(f"[kernels] quantize_int8 / dequantize_int8: bit-identical to the plain versions on "
        f"{len(flats)} micro-lm leaves and {len(RAGGED_GROUPS)} ragged group counts")

    n = sum(x.numel() for x in flats)  # one save / one restore: every leaf once
    slice_codes = codes[: len(flats)]
    q_ms = time_ms(lambda: [quantize_int8_cuda(x) for x in flats])
    q_plain = time_ms(lambda: [ref.quantize_int8_ref(x) for x in flats])
    d_ms = time_ms(lambda: [dequantize_int8_cuda(q, s) for q, s in slice_codes])
    d_plain = time_ms(lambda: [ref.dequantize_int8_ref(q, s) for q, s in slice_codes])
    d_lib = time_ms(lambda: [torch.mul(q.view(-1, 256), s.view(-1, 1)) for q, s in slice_codes])
    q_bound, q_by = bound(4 * n + n + 4 * (n // 256), n)  # one division per element
    d_bound, d_by = bound(n + 4 * (n // 256) + 4 * n, n)
    quant = dict(max_abs_err=0.0, ms=q_ms, plain_ms=q_plain, library_ms=None, bound_ms=q_bound,
                 bound_by=q_by)
    dequant = dict(max_abs_err=0.0, ms=d_ms, plain_ms=d_plain, library_ms=d_lib,
                   bound_ms=d_bound, bound_by=d_by)
    return quant, dequant


def check_slice(res: SliceResult, cfg, params, prompts, dev):
    """Outputs of the slice against the plain path on the CPU."""
    model = build_model(cfg)
    vocab = cfg.vocab_size
    for name, logits in (("site A", res.logits_a), ("site B", res.logits_b)):
        if logits.shape != (BATCH, PROMPT, vocab) or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{name} prefill logits: shape {tuple(logits.shape)} or not finite")
    for name, toks in (("site A", res.tokens_a), ("site B", res.tokens_b)):
        if toks.shape != (BATCH, PROMPT + NEW) or not torch.equal(toks[:, :PROMPT], prompts):
            raise RuntimeError(f"{name} decode tokens: shape {tuple(toks.shape)} or prompt lost")
        if int(toks.min()) < 0 or int(toks.max()) >= vocab:
            raise RuntimeError(f"{name} decode produced out-of-vocab tokens")

    host = params_to_numpy(params)
    cpu_bytes = ser.to_bytes(ser.serialize_tree(host, mode="int8", device="cpu"))
    if res.manager.export_bytes() != cpu_bytes:
        raise RuntimeError("int8 checkpoint written on the card differs from the CPU plain path's")
    rep = res.report
    if rep.nbytes != res.nbytes or rep.workload_class != 0 or rep.feasible_in_window is not True:
        raise RuntimeError(f"migration report {rep} vs latest_bytes {res.nbytes}")
    restored_cpu, _ = res.manager.restore(host, device="cpu")
    for (path, a), (_, b) in zip(flatten_with_paths(res.params_b), flatten_with_paths(restored_cpu)):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError(f"restored leaf {'/'.join(path)} differs from the CPU plain dequantize")
    log(f"[checks] int8 checkpoint byte-identical to the CPU plain path ({len(cpu_bytes)} B); "
        f"restored params bit-identical to the CPU plain dequantize")

    # Small input at full width: the card against the CPU plain path, and
    # prefill against step-by-step decode on the card.
    small = prompts[:2, :64]
    sites = (("site A", params, params_from_numpy(host, "cpu")),
             ("site B", res.params_b, restored_cpu))
    for name, p, p_cpu in sites:
        card, _ = model.forward(p, {"tokens": small})
        plain, _ = model.forward(p_cpu, {"tokens": small.cpu()})
        err = float((card.cpu() - plain).abs().max())
        if not torch.allclose(card.cpu(), plain, atol=MODEL_TOL, rtol=MODEL_TOL):
            raise RuntimeError(f"{name} forward on the card vs the CPU plain path: {err}")
        cache = model.init_cache(small.shape[0], small.shape[1], device=dev)
        steps = []
        for i in range(small.shape[1]):
            lg, cache = model.decode_step(p, cache, {"token": small[:, i], "index": i})
            steps.append(lg)
        derr = float((torch.stack(steps, 1) - card).abs().max())
        if not torch.allclose(torch.stack(steps, 1), card, atol=DECODE_TOL, rtol=DECODE_TOL):
            raise RuntimeError(f"{name} prefill vs step-by-step decode on the card: {derr}")
        log(f"[checks] {name}: forward on the card vs CPU plain path max abs err {err:.3e} "
            f"(tol {MODEL_TOL}); prefill vs decode {derr:.3e} (tol {DECODE_TOL})")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))


def phase_profile(cfg, params, prompts, dev) -> None:
    """Device busy share and top kernels for one prefill and for 16 decode
    steps, from torch.profiler (CUPTI).  Runs after the slice: its launches
    are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = build_model(cfg)
    cache = model.init_cache(prompts.shape[0], prompts.shape[1] + NEW, device=dev)

    def prefill():
        model.forward(params, {"tokens": prompts})

    def decode():
        for i in range(16):
            model.decode_step(params, cache, {"token": prompts[:, i], "index": i})

    for name, fn in (("prefill", prefill), ("decode x16", decode)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: a CPU op's own entry repeats its kernels' time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
        busy_us = sum(_device_us(e) for e in kernels)
        if not kernels:
            log(f"[profile] {name}: device time not measured (the profiler saw no device events)")
            continue
        log(f"[profile] {name}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
            f"({100 * busy_us / wall_us:.1f}%), idle {100 * (1 - busy_us / wall_us):.1f}%")
        for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
            log(f"[profile]   {_device_us(e):9.0f} us  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    kind = phase_device()
    dev = resolve("cuda")
    phase_build()

    gen = torch.Generator().manual_seed(0)
    cfg = get_config("micro-lm")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n_params = sum(x.numel() for _, x in flatten_with_paths(params))
    leaves = [x for _, x in flatten_with_paths(params)]
    stats = {"flash_attention": check_flash(dev, gen)}
    stats["quantize_int8"], stats["dequantize_int8"] = check_quantize(dev, gen, leaves)
    for name, st in stats.items():
        lib = "null" if st["library_ms"] is None else f"{st['library_ms']:.4f}"
        log(f"[kernels] {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {st['bound_ms']:.4f} ms ({st['bound_by']})")

    data = SyntheticLMDataset(cfg.vocab_size, PROMPT, BATCH, seed=1)
    prompts = torch.from_numpy(data.batch(0)["tokens"]).long().to(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        ops.reset_launch_counts()
        res = run_slice(cfg, params, prompts, work, max_new=NEW, device=dev)
        launches = ops.launch_counts()
        expect = {"flash_attention": 2 * cfg.num_layers, "quantize_int8": len(leaves),
                  "dequantize_int8": len(leaves)}
        if launches != expect:
            raise RuntimeError(f"launch counts of the slice {launches}, expected {expect}")
        log(f"[slice] micro-lm, {n_params} params, {BATCH} requests x {PROMPT} prompt + {NEW} "
            f"new tokens; launches {launches}")
        for site, pre, dec in (("A", res.prefill_a_s, res.decode_a_s),
                               ("B", res.prefill_b_s, res.decode_b_s)):
            log(f"[slice] site {site}: prefill {pre * 1e3:.2f} ms; decode "
                f"{BATCH * NEW / dec:.1f} new tok/s ({(PROMPT + NEW - 1) / dec:.1f} steps/s, "
                f"{dec:.3f} s)")
        v = res.verdict
        log(f"[slice] int8 checkpoint {res.nbytes} B saved in {res.save_s:.3f} s; gate: class "
            f"{int(v.workload_class)}, t_transfer {float(v.t_transfer_s):.4f} s, t_cost "
            f"{float(v.t_cost_s):.4f} s, feasible {bool(v.feasible)}; migrate {res.migrate_s:.3f} s; "
            f"restore {res.restore_s:.3f} s")
        check_slice(res, cfg, params, prompts, dev)
    phase_profile(cfg, params, prompts, dev)

    rows = []
    for name, st in stats.items():
        rows.append(dict(name=name, **KERNELS[name], launches=launches[name],
                         max_abs_err=st["max_abs_err"], max_err=st["max_abs_err"],
                         ms=st["ms"], kernel_ms=st["ms"], plain_ms=st["plain_ms"],
                         bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                         library_ms=st["library_ms"]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
