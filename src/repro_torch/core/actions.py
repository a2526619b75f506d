"""Typed orchestration actions (the control vocabulary of §V).

The paper's published evaluation only exercises migration, but its extended
control model (§VIII: demand response, grid-aware throttling, deferral until
a renewable window) needs a richer verb set than ``(job_id, dest)`` tuples.
Every policy returns a list of these actions; the simulator validates and
applies them, counting ill-typed or stale ones in ``SimResult`` instead of
crashing mid-run.

Semantics (enforced by ``ClusterSimulator._apply_action``):

  Migrate(jid, dest)        pause -> WAN transfer -> load -> re-queue at dest.
                            Valid only for a *running* job, dest != current.
  Defer(jid, until_s)       hold a *queued* job out of FIFO scheduling until
                            sim-time ``until_s`` (wait-for-window).
  Pause(jid)                stop a *running* job and free its slot; the job
                            keeps its progress and waits for Resume.
  Resume(jid)               re-queue a *paused* job (FIFO by arrival time).
  Throttle(jid, power_frac) run a *running* job at ``power_frac`` of nominal
                            power and speed (demand response). 1.0 restores
                            full power; values are clamped to [0.0, 1.0].
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Action:
    """Base class: every action names the job it applies to."""

    jid: int


@dataclass(frozen=True)
class Migrate(Action):
    dest: int


@dataclass(frozen=True)
class Defer(Action):
    until_s: float


@dataclass(frozen=True)
class Pause(Action):
    pass


@dataclass(frozen=True)
class Resume(Action):
    pass


@dataclass(frozen=True)
class Throttle(Action):
    power_frac: float


__all__ = ["Action", "Migrate", "Defer", "Pause", "Resume", "Throttle"]
