"""Config for h2o-danube-1.8b (assignment-exact dims). See registry.py."""
from .registry import h2o_danube_1p8b, get_smoke_config

CONFIG = h2o_danube_1p8b()
SMOKE = get_smoke_config('h2o-danube-1.8b')
