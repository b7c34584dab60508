from .optimizer import (optimize_placement, PlacementResult,  # noqa: F401
                        METHODS, METHOD_ALIASES)
from .baselines import chip_init, zigzag, sigmate  # noqa: F401
from .ppo import PPOConfig, run_ppo  # noqa: F401
