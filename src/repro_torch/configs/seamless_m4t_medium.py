"""Config for seamless-m4t-medium (assignment-exact dims). See registry.py."""
from .registry import seamless_m4t_medium, get_smoke_config

CONFIG = seamless_m4t_medium()
SMOKE = get_smoke_config('seamless-m4t-medium')
