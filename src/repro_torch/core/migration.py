"""Migration engine (port of ``repro/core/migration.py``): the glue between
the orchestrator's decision and the substrate's mechanism.

migrate_job() performs a real end-to-end migration between two site
directories: export the newest checkpoint, model the WAN transfer with the
feasibility equations (optionally sleeping for it), and import at the
destination, whose manager then restores onto its own device.

Returns a MigrationReport whose timings are exactly the terms of eq. (1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from repro_torch import spans
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import feasibility as fz


@dataclass
class MigrationReport:
    job: str
    step: int
    nbytes: int
    bandwidth_bps: float
    t_transfer_s: float  # modeled WAN time (eq. 1 dominant term)
    t_serialize_s: float  # measured local export time
    t_load_s: float  # modeled restore/load time
    t_downtime_s: float
    workload_class: int  # 0=A, 1=B, 2=C
    feasible_in_window: Optional[bool]

    @property
    def t_cost_s(self) -> float:
        return self.t_transfer_s + self.t_load_s + self.t_downtime_s


def migrate_job(
    src: CheckpointManager,
    dst_root: str,
    *,
    bandwidth_bps: float = 10e9,
    window_s: Optional[float] = None,
    t_load_s: float = fz.T_LOAD_S,
    realtime: bool = False,
) -> tuple[CheckpointManager, MigrationReport]:
    """Move the newest checkpoint of ``src`` to ``dst_root`` over a WAN model
    (spans ``migrate.export`` and ``migrate.import``)."""
    t0 = time.time()
    with spans.span("migrate.export"):
        raw = src.export_bytes()
    t_ser = time.time() - t0
    nbytes = len(raw)
    t_transfer = float(fz.transfer_time_s(nbytes, bandwidth_bps))
    if realtime:
        time.sleep(min(t_transfer, 5.0))  # bounded demo sleep
    step = src.latest.step
    with spans.span("migrate.import"):
        dst = CheckpointManager.import_bytes(dst_root, src.job, step, raw)
    verdict = None
    if window_s is not None:
        verdict = bool(fz.evaluate(nbytes, bandwidth_bps, window_s, t_load_s=t_load_s).feasible)
    report = MigrationReport(
        job=src.job,
        step=step,
        nbytes=nbytes,
        bandwidth_bps=bandwidth_bps,
        t_transfer_s=t_transfer,
        t_serialize_s=t_ser,
        t_load_s=t_load_s,
        t_downtime_s=fz.T_DOWNTIME_S,
        workload_class=int(fz.classify(nbytes, bandwidth_bps)),
        feasible_in_window=verdict,
    )
    return dst, report
