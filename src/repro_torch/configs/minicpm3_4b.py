"""Config for minicpm3-4b (assignment-exact dims). See registry.py."""
from .registry import minicpm3_4b, get_smoke_config

CONFIG = minicpm3_4b()
SMOKE = get_smoke_config('minicpm3-4b')
