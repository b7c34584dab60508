"""Config for deepseek-v3-671b (assignment-exact dims). See registry.py."""
from .registry import deepseek_v3_671b, get_smoke_config

CONFIG = deepseek_v3_671b()
SMOKE = get_smoke_config('deepseek-v3-671b')
