"""Build the port's CUDA kernels into one shared library and load it.

The sources are ``csrc/*.cu`` in this package, each with a plain C
interface (no PyTorch headers), so each compiles in seconds; the two flash
attention sources share ``csrc/flash_common.cuh``.  The library goes to
``build/`` at the repository root, named by a hash of the sources, the
header and the flags: a changed source gives a new name, hence a rebuild.  All
sources compile in parallel (one ``nvcc`` each), then link once.  The
build runs on first use, never at import, and only on a machine with
``nvcc``; the CPU path never reaches it.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parents[1] / "build"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "quantize.cu", "decide.cu")
HEADERS = ("flash_common.cuh",)
# sm_90a: Hopper with its arch-specific instructions (wgmma, setmaxnreg).
# Never --use_fast_math: the quantize and decide kernels rely on IEEE
# division (decide.cu also writes every float64 op as an _rn intrinsic, so
# no --fmad flag is needed for it).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_dbl = ctypes.c_double
SIGNATURES = {
    # q, k, v, o, lse, b, s, t, nh, nkv, hd, mask, window, softcap, scale,
    # dtype, device, stream
    "repro_flash_attention_fwd": [_c_ptr] * 5 + [_c_int] * 8
    + [ctypes.c_float, ctypes.c_float, _c_int, _c_int, _c_ptr],
    # q, k, v, o, lse, do, dq, dk, dv, delta, b, s, t, nh, nkv, hd, mask,
    # window, softcap, scale, dtype, device, stream
    "repro_flash_attention_bwd": [_c_ptr] * 10 + [_c_int] * 8
    + [ctypes.c_float, ctypes.c_float, _c_int, _c_int, _c_ptr],
    # x, q, scale, groups, device, stream
    "repro_quantize_int8_f32": [_c_ptr] * 3 + [_c_ll, _c_int, _c_ptr],
    # q, scale, x, n, device, stream
    "repro_dequantize_int8_f32": [_c_ptr] * 3 + [_c_ll, _c_int, _c_ptr],
    # jobs, sites, bw, dest, B, K, S, alpha, gamma, betaqp, queue_penalty_s,
    # min_benefit_s, ppf_sigma, use_stoch, energy_ratio, t_downtime_s,
    # class_c_s, device, stream
    "repro_decide_dest_f64": [_c_ptr] * 4 + [_c_ll] * 3 + [_c_dbl] * 6 + [_c_int]
    + [_c_dbl] * 3 + [_c_int, _c_ptr],
}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}")
    return logs


def build() -> Path:
    """Compile and link the library if this source hash has none yet.
    Returns its path; the compiler's log (registers, spills) lies beside it."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        nvcc = find_nvcc()
        t0 = time.time()
        objs = [BUILD_DIR / f"{path.stem}_{Path(s).stem}.o" for s in SOURCES]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", str(o)]
                         for s, o in zip(SOURCES, objs)])
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        logs += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           *map(str, objs), "-o", str(tmp)]])
        os.replace(tmp, path)
        log_path(path).write_text(
            f"built in {time.time() - t0:.1f} s with {nvcc}\n" + "\n".join(logs))
        for o in objs:
            o.unlink()
    return path


def log_path(lib: Path) -> Path:
    return lib.with_suffix(".log")


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every entry's
    argument types set (a pointer passed without them is cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
