"""Config for qwen3-moe-30b-a3b (assignment-exact dims). See registry.py."""
from .registry import qwen3_moe_30b, get_smoke_config

CONFIG = qwen3_moe_30b()
SMOKE = get_smoke_config('qwen3-moe-30b-a3b')
