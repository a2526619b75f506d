#!/usr/bin/env python3
"""Time variants of the attention backward kernel on one CUDA card.

    git show <rev>:src/repro_torch/csrc/flash_attention_bwd.cu > build/parent_bwd.cu
    python3 tools/bwd_variants.py [--parent build/parent_bwd.cu]

Builds src/repro_torch/csrc/flash_attention_bwd.cu as it is ("repo"), each
entry of VARIANTS (the same source with one design constant changed) and,
if given, an earlier design of the file whose C entry has no dtype argument
(float32 only, as before bf16 training), each into its own library under
build/variants/.  Prints each library's hd-64 registers and spills
(ptxas -v), holds each against the plain version at the training slice's
shape (8, 512, 6, 64) causal, and times them in turns (in order, reversed,
in order, reversed; median of chip_smoke.time_ms each), float32 and bf16,
with the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_lse_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
SHAPE = (cs.BATCH, cs.PROMPT, 6, 64)  # (b, s, nh, hd), causal
_NC = "static constexpr int kNC = kF32 ? (kBn > 32 ? 32 : kBn) : 16;"
_LB = "__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(const BwdArgs a) {"
# name -> (text in the source, its replacement), each a change of one design constant
VARIANTS = {
    "a minimum of one block an SM": [(_LB, _LB.replace("(kThreads)", "(kThreads, 1)"))],
    "float32 16-row passes": [(_NC, "static constexpr int kNC = kF32 ? 16 : 16;")],
    "bf16 32-row passes": [(_NC, "static constexpr int kNC = kF32 ? (kBn > 32 ? 32 : kBn) : 32;")],
    "bf16 32-row passes, 3 blocks an SM": [
        (_NC, "static constexpr int kNC = kF32 ? (kBn > 32 ? 32 : kBn) : 32;"),
        (_LB, _LB.replace("(kThreads)", "(kThreads, std::is_same<T, float>::value ? 1 : 3)"))],
}


def build_all(parent: str | None) -> dict:
    """Start every nvcc at once; returns name -> (library path, ptxas log)."""
    src = open(os.path.join(_build.CSRC_DIR, "flash_attention_bwd.cu")).read()
    jobs = {"repo": src}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        jobs[name] = text
    if parent:
        jobs["parent"] = open(parent).read()
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, text) in enumerate(jobs.items()):
        d = os.path.join(OUT, str(i))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "flash_attention_bwd.cu"), "w") as f:
            f.write(text)
        for h in _build.HEADERS:
            shutil.copy(os.path.join(_build.CSRC_DIR, h), d)
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, os.path.join(d, "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load()  # the repository's library, for K1's output and lse
    out = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        out[name] = (lib, log)
    return out


def hd64_ptxas(log: str) -> list:
    """(kernel, registers and spills) of each hd-64 backward kernel in a ptxas log."""
    lines = log.splitlines()
    rows = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "Li64E" in line and "delta" not in line:
            kind = "bf16" if "bfloat16" in line else "f32"
            role = "dq" if "dq_kernel" in line else "dkdv" if "dkdv" in line else ""
            spill = lines[i + 2].split(",", 1)[1].strip() if i + 2 < len(lines) else ""
            regs = lines[i + 3].split(":", 1)[1].split(",")[0].strip() if i + 3 < len(lines) else ""
            rows.append((f"{kind} {role}".strip(), f"{regs}, {spill}"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier flash_attention_bwd.cu (float32 entry, no dtype)")
    args = ap.parse_args(argv)
    cs.phase_device()
    libs = build_all(args.parent)
    fns = {}
    for name, (lib, log) in libs.items():
        for kernel, regs in hd64_ptxas(log):
            print(f"[variants] {name}: {kernel} hd 64: {regs}")
        fn = ctypes.CDLL(lib).repro_flash_attention_bwd
        fn.restype = ctypes.c_int
        sig = _build.SIGNATURES["repro_flash_attention_bwd"]
        fn.argtypes = sig if name != "parent" else sig[:-3] + sig[-2:]  # no dtype
        fns[name] = fn

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    b, s, nh, hd = SHAPE
    for dtype, tol in ((torch.float32, cs.GRAD_TOL), (torch.bfloat16, cs.GRAD_BF16_TOL)):
        q, k, v, do = (cs.randn(gen, (b, s, nh, hd), dev).to(dtype) for _ in range(4))
        o, lse = flash_attention_lse_cuda(q, k, v)
        want = ref.flash_attention_bwd_ref(q, k, v, do)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        delta = torch.empty((b, nh, s), device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call(name):
            kind = [] if name == "parent" else [0 if dtype == torch.float32 else 1]
            err = fns[name](*(x.data_ptr() for x in (q, k, v, o, lse, do, *grads, delta)),
                            b, s, s, nh, nh, hd, 1, 0, 0.0, hd ** -0.5, *kind, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err} at launch")

        names = [n for n in fns if n != "parent" or dtype == torch.float32]
        for name in names:
            call(name)
            torch.cuda.synchronize()
            share = max(float((g.float() - w.float()).abs().max()) / (tol * float(w.float().abs().max()))
                        for g, w in zip(grads, want))
            if not share <= 1.0:
                raise RuntimeError(f"{name} {dtype}: {100 * share:.1f}% of the tolerance {tol}")
            print(f"[variants] {name} {dtype}: within {tol} x max|grad| ({100 * share:.1f}% of it)")
        times = {n: [] for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                times[name].append(cs.time_ms(lambda: call(name)))
        for name in names:
            print(f"[variants] {name} {dtype} at {SHAPE} causal: {statistics.median(times[name]):.4f} ms "
                  f"(turns {', '.join(f'{t:.4f}' for t in times[name])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
