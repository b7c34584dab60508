"""Deployment engine: profile -> partition -> place -> schedule.

``deploy_model`` runs the paper's whole flow in one call and returns a
:class:`DeploymentPlan`; :mod:`.objective` defines the pluggable objectives
every placement optimizer scores against. The request layer, plan cache,
service and runtime of the reference are not ported yet.
"""
from .objective import (EnergyModel, MigrationSpec, Objective,  # noqa: F401
                        OBJECTIVES, as_objective, objective_scorer,
                        partition_interchip_bytes, with_migration)
from .engine import DeploymentPlan, SCHEDULES, deploy_model  # noqa: F401
