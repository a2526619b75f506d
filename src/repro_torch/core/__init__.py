"""The paper's contribution, ported: the feasibility-domain model
(§IV/§VI), feasibility-aware orchestration (§V, Algorithm 1) behind a
typed Action/ClusterState API, CAISO-calibrated traces, a scenario
registry, the trace-driven multi-site simulator (§VII), the Monte-Carlo
sweep engine, and the migration engine.

Numpy host code, as in the JAX package; the migration decide of the
K4-scoring policies runs the hand-written decide kernel on the chosen
device (``policy_kernels``).  Not ported yet (ROADMAP Queue 1, item 11):
the chunked serving fast path (``serving_kernels.py``), ``energy.py``,
and ``classify_by_size``, ``phase_diagram``, ``site_utility`` and
``feasible_destinations`` of ``feasibility.py``.
"""
from repro_torch.core import feasibility  # noqa: F401
from repro_torch.core.feasibility import (  # noqa: F401
    ALPHA, CLASS_A_MAX_S, CLASS_B_MAX_S, P_NODE_KW, P_SYS_KW,
    FeasibilityVerdict, breakeven_time_s, classify, evaluate,
    migration_cost_s, migration_energy_kwh, stochastic_feasible,
    transfer_time_s,
)
from repro_torch.core.actions import (  # noqa: F401
    Action, Defer, Migrate, Pause, Resume, Throttle,
)
from repro_torch.core.state import (  # noqa: F401
    ClusterState, JobSoA, JobView, SiteView, advertised_bandwidth,
    nic_share_counts,
)
from repro_torch.core.orchestrator import (  # noqa: F401
    DeferConfig, DeferToWindowPolicy, EnergyOnlyPolicy, FeasibilityAwarePolicy,
    FeasibilityConfig, GridThrottlePolicy, OraclePolicy, OrchestratorContext,
    PlanAheadConfig, PlanAheadPolicy, Policy, PolicyConfig,
    RecedingHorizonConfig, RecedingHorizonPolicy, StaticPolicy,
    ThrottleConfig, available_policies, make_policy, register_policy,
)
from repro_torch.core.forecast import (  # noqa: F401
    ForecastHorizon, OutageForecast, WindowForecast,
)
from repro_torch.core.ledger import (  # noqa: F401
    BatteryConfig, DVFS_CURVE_POINTS, PowerLedger, ThrottleCurve,
)
from repro_torch.core.signals import (  # noqa: F401
    CurtailRequest, GridSignals, SignalProfile, SignalStack,
    curtail_requests_from_carbon, generate_signals, grid_signal_integral,
)
from repro_torch.core.wan import (  # noqa: F401
    WanProfile, WanTopology, hub_spoke_links, partitioned_links,
)
from repro_torch.core.serving import (  # noqa: F401
    DEFAULT_MODEL_CLASSES, ModelClass, Request, RequestBatch, Router,
    ServingPlane, ServingProfile, ServingView, available_routers,
    generate_requests, make_router, register_router,
)
from repro_torch.core.scenarios import (  # noqa: F401
    FailureRegime, ForecastNoise, JobMix, Scenario,
    available_scenarios, get_scenario, register_scenario,
)
from repro_torch.core.simulator import (  # noqa: F401
    ClusterSimulator, SimConfig, SimJob, SimResult, generate_jobs,
    normalized_table, run_policy_comparison,
)
from repro_torch.core.traces import (  # noqa: F401
    Forecaster, SiteTrace, TraceProfile, TraceStack, Window, generate_trace,
    stack_traces, trace_stats,
)
from repro_torch.core.sweep import (  # noqa: F401
    RunRecord, SweepResult, SweepSpec, run_sweep,
)
