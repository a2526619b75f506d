"""Reading a ``torch.profiler`` trace of the card.

The profiler's Chrome trace holds device activity (``kernel``,
``gpu_memcpy``, ``gpu_memset``), the host's runtime calls that launched it
(``cuda_runtime`` / ``cuda_driver``, joined to their device activity by
``args.correlation``), the host's operators (``cpu_op``) and the
benchmark's own ranges (``user_annotation``), with times in microseconds.
A device operation belongs to a host range when the call that launched it
was made inside the range, on any thread: the autograd engine launches the
backward pass from its own thread while the caller waits in the range.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: List[dict], window: str = "perfbench.window"):
        """The traced window is the span of the host range ``window``."""
        self.device = []  # (start, end, name, correlation)
        launch_ts: Dict[int, float] = {}
        self.ranges = defaultdict(list)  # name -> [(start, end)]
        self.host_ops = []  # (start, end, name)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launch_ts[args["correlation"]] = ts
            elif cat == "user_annotation":
                self.ranges[e.get("name", "")].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.host_ops.append((ts, ts + dur, e.get("name", "")))
        spans = self.ranges.get(window)
        if not spans:
            raise ValueError(f"the trace has no range {window!r}")
        self.t0, self.t1 = min(s for s, _ in spans), max(e for _, e in spans)
        self.device = [d for d in self.device if d[1] > self.t0 and d[0] < self.t1]
        self.device.sort()
        self.launched_at = {d[3]: launch_ts.get(d[3]) for d in self.device}

    @classmethod
    def from_file(cls, path: str, window: str = "perfbench.window") -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data, window)

    # -- the whole window ----------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    # -- device operations ---------------------------------------------------
    def kernels(self, *names: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose bare name (no
        ``void``, template or argument list) is one of ``names``."""
        sel = [d for d in self.device if bare(d[2]) in names]
        return sum(e - s for s, e, _, _ in sel) / 1e6, len(sel)

    def _spans(self, name: str) -> List[Tuple[float, float]]:
        """The union of the host range ``name``'s spans (nested or on several
        threads)."""
        out: List[List[float]] = []
        for s, e in sorted(self.ranges.get(name, [])):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def in_range(self, name: str, exclude: Tuple[str, ...] = ()) -> Optional[float]:
        """Device seconds of the operations launched inside the host range
        ``name`` and outside every range of ``exclude``; None if ``name``
        never ran."""
        spans = self._spans(name)
        if not spans:
            return None
        skip = [self._spans(x) for x in exclude]

        def inside(sp, t):
            starts = [s for s, _ in sp]
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= sp[i][1]

        total = 0.0
        for s, e, _, corr in self.device:
            t = self.launched_at.get(corr)
            if t is not None and inside(spans, t) and not any(inside(sp, t) for sp in skip):
                total += e - s
        return total / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for s, e, name, _ in self.device:
            by[short(name)] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches with nothing on the device, each named
        by the innermost benchmark range and host operator running at its
        middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            out.append([self._host_at((s + e) / 2), (e - s) / 1e6])
        return out

    def _host_at(self, t: float) -> str:
        def innermost(spans):
            best = None
            for s, e, name in spans:
                if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
            return best[2] if best else None

        rng = innermost([(s, e, k) for k, v in self.ranges.items() for s, e in v])
        op = innermost(self.host_ops)
        return "/".join(x for x in (rng, op) if x) or "host idle or untraced"


def bare(name: str) -> str:
    """A kernel's function name: ``void (anonymous namespace)::f<T, 64>(int)``
    gives ``f``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i >= 0]
    if cut:
        name = name[: min(cut)]
    return name.rsplit("::", 1)[-1].strip()


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = name.replace("(anonymous namespace)::", "")
    if "(" in name:
        name = name[: name.index("(")]
    return name[:width]
