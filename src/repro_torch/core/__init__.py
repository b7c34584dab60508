"""The paper's contribution: balanced partitioning + RL core placement + pipelining."""
from .graph import LogicalGraph, chain_graph, random_dag  # noqa: F401
from .topology import (DegradedTopology, GridTopology,  # noqa: F401
                       HierarchicalMesh, InfeasibleTopologyError, Topology,
                       degrade, parse_topology)
from .noc import NoC, NoCMetrics  # noqa: F401
from .noc_batch import (BatchedNoC, BatchMetrics, batched_noc,  # noqa: F401
                        comm_cost_batch, directional_cdv_batch, evaluate_batch)
from .partition import (CHIP_STRATEGIES, STRATEGIES, CoreSpec,  # noqa: F401
                        LayerProfile, Partition, partition_model)
from . import noc_batch, pipeline  # noqa: F401
