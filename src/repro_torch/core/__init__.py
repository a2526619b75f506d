"""The paper's feasibility model and migration engine.  The orchestration
core (traces, policies, simulator, serving plane) is not ported yet
(ROADMAP Queue 1, item 11)."""
from repro_torch.core import feasibility  # noqa: F401
