"""Error-bounded adaptive query planner (hybrid exact + sampled).

`QueryPlanner` inverts the budget contract: callers state an error bound
and the planner escalates partition reads until the measured confidence
interval satisfies it, consulting materialized views first so sampling
only pays for the residual.  See `docs/planner.md`.
"""
from repro_torch.planner.planner import (
    PlannedAnswer,
    PlannerConfig,
    QueryPlan,
    QueryPlanner,
)
from repro_torch.planner.variance import (
    StratifiedEstimate,
    prior_budget,
    stratified_answer,
)
from repro_torch.planner.views import MaterializedView, ViewStore

__all__ = [
    "MaterializedView",
    "PlannedAnswer",
    "PlannerConfig",
    "QueryPlan",
    "QueryPlanner",
    "StratifiedEstimate",
    "ViewStore",
    "prior_budget",
    "stratified_answer",
]
