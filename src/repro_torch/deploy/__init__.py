"""Deployment engine: profile -> partition -> place -> schedule.

``deploy_model`` runs the paper's whole flow in one call and returns a
:class:`DeploymentPlan`; :mod:`.objective` defines the pluggable objectives
every placement optimizer scores against. ``python -m repro_torch.deploy``
sweeps models × methods × objectives from the command line.

Deployment-as-a-service lives on top: :class:`DeployRequest`
(:mod:`.request`) canonicalizes one deployment call into a hashable,
JSON-able value whose cache key is the JAX package's for the same call;
:class:`PlanCache` / :class:`PlacementService` (:mod:`.plancache` /
:mod:`.service`) serve cached plans, warm-start near misses, and fuse
concurrent same-topology searches into one batched scorer call.
:func:`run_scenario` (:mod:`.runtime`) re-places a live deployment online
under faults and traffic drift.
"""
from .objective import (EnergyModel, MigrationSpec, Objective,  # noqa: F401
                        OBJECTIVES, as_objective, objective_scorer,
                        partition_interchip_bytes, with_migration)
from .engine import (DeploymentPlan, SCHEDULES, deploy_model,  # noqa: F401
                     execute_request, instantiate_plan)
from .request import (DeployRequest, RequestEncodeError,  # noqa: F401
                      topology_from_key)
from .plancache import PlanCache  # noqa: F401
from .service import DeployResponse, PlacementService  # noqa: F401
from .runtime import (Scenario, ScenarioEvent, ScenarioResult,  # noqa: F401
                      parse_scenario, run_scenario)
