"""Config for llava-next-34b (assignment-exact dims). See registry.py."""
from .registry import llava_next_34b, get_smoke_config

CONFIG = llava_next_34b()
SMOKE = get_smoke_config('llava-next-34b')
