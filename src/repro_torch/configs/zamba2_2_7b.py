"""Config for zamba2-2.7b (assignment-exact dims). See registry.py."""
from .registry import zamba2_2p7b, get_smoke_config

CONFIG = zamba2_2p7b()
SMOKE = get_smoke_config('zamba2-2.7b')
