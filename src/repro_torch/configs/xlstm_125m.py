"""Config for xlstm-125m (assignment-exact dims). See registry.py."""
from .registry import xlstm_125m, get_smoke_config

CONFIG = xlstm_125m()
SMOKE = get_smoke_config('xlstm-125m')
