"""Hardware power/energy classes (paper §II Table I) + TPU extension; the
port's copy of ``repro/core/energy.py``.

The paper's methodology (§II.E) derives these from public specs, not new
measurements; we encode the same mid-range values and reproduce Table I from
them (benchmarks/table1_hardware.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class HardwareClass:
    name: str
    power_kw: Tuple[float, float]  # (min, max) typical wall power
    perf_per_watt: Tuple[float, float]  # system-level TFLOPS/W (bf16-class)
    usd_per_tflop: float
    peak_tflops: float  # dense bf16-class peak per unit

    @property
    def power_typ_kw(self) -> float:
        return 0.5 * (self.power_kw[0] + self.power_kw[1])

    @property
    def perf_per_watt_typ(self) -> float:
        return 0.5 * (self.perf_per_watt[0] + self.perf_per_watt[1])


# Table I (2025 figures as printed in the paper)
TABLE_I: Dict[str, HardwareClass] = {
    "rtx4090-gpu-only": HardwareClass("RTX4090 (GPU only)", (0.45, 0.45), (0.73, 0.73), 6.0, 330.0),
    "a100-80gb-gpu-only": HardwareClass("A100 80GB (GPU only)", (0.35, 0.35), (0.78, 0.78), 38.0, 312.0),
    "rtx4090-mini-pc": HardwareClass("RTX4090 mini-PC", (0.6, 0.9), (0.37, 0.55), 8.0, 330.0),
    "4xa100-node": HardwareClass("4xA100 node", (2.0, 2.5), (0.50, 0.62), 40.0, 1248.0),
    "8xa100-dgx": HardwareClass("8xA100 DGX", (4.0, 4.5), (0.55, 0.63), 60.0, 2496.0),
    # §II.F 100 W-class edge nodes (Jetson Thor: 2070 FP4 TFLOPS, 40-130 W)
    "jetson-thor": HardwareClass("Jetson Thor edge node", (0.10, 0.15), (2.0, 4.0), 3.0, 2070.0 / 4),
    # TPU v5e, per chip: a spec row the JAX package's table carries (its
    # target), kept for parity.  A spec sheet's figures, not a measurement
    # of this port or of its card.
    "tpu-v5e-chip": HardwareClass("TPU v5e (chip)", (0.25, 0.30), (0.66, 0.79), 8.0, 197.0),
}

# §II.C energy-per-sample reference points (ViT-B/32 fine-tune)
ENERGY_PER_SAMPLE_MJ = {
    "rtx4090-mini-pc": 2.7,  # 750 W system
    "4xa100-node": 6.5,  # 6-7 mJ/sample, single active GPU
}


def joules_per_sample(hw: HardwareClass, samples_per_sec: float, active_fraction: float = 1.0) -> float:
    """System-level J/sample at a given throughput (paper §II.C model)."""
    return hw.power_typ_kw * 1e3 * active_fraction / samples_per_sec


def node_energy_kwh(power_kw: float, hours: float) -> float:
    return power_kw * hours


# Paper §IV.D / §VII operating points
P_SYS_TRANSFER_KW = 1.8
P_NODE_COMPUTE_KW = 0.75
