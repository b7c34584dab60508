"""Config for phi3-medium-14b (assignment-exact dims). See registry.py."""
from .registry import phi3_medium_14b, get_smoke_config

CONFIG = phi3_medium_14b()
SMOKE = get_smoke_config('phi3-medium-14b')
