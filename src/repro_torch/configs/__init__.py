"""Model configurations of the LM zoo (``repro.configs``)."""
from .registry import (ARCHS, SHAPES, LONG_OK, cells, get_config,  # noqa: F401
                       get_smoke_config)
