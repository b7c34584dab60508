"""Config for internlm2-1.8b (assignment-exact dims). See registry.py."""
from .registry import internlm2_1p8b, get_smoke_config

CONFIG = internlm2_1p8b()
SMOKE = get_smoke_config('internlm2-1.8b')
