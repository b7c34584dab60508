from .optimizer import (optimize_placement, PlacementResult,  # noqa: F401
                        METHODS, METHOD_ALIASES)
from .baselines import (chip_init, zigzag, sigmate, random_search,  # noqa: F401
                        simulated_annealing)
from .population import (genetic_population,  # noqa: F401
                         random_search_population,
                         simulated_annealing_population)
from .device_search import (genetic_device,  # noqa: F401
                            simulated_annealing_device)
from .multilevel import (CoarseningLevel, coarsen, coarsen_once,  # noqa: F401
                         grid_comm_cost, heavy_edge_matching,
                         multilevel_placement, project_placement,
                         refine_placement)
from .policy_baseline import PolicyConfig, run_policy_baseline  # noqa: F401
from .ppo import PPOConfig, run_ppo  # noqa: F401
