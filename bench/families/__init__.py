"""Model families: how a configuration file becomes the port's
configuration, its model FLOPs a token and its attention calls a step."""
from __future__ import annotations

import dataclasses

DTYPE_KEYS = ("param_dtype", "dtype")


def base_config(cfg: dict):
    """The registry's entry named in ``port.registry`` (its CPU smoke size
    where ``port.smoke``), with ``port.replace`` applied (dtypes by their
    torch names)."""
    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
    port = cfg["port"]
    base = (get_smoke_config if port.get("smoke") else get_config)(
        port["registry"])
    rep = {k: getattr(torch, v) if k in DTYPE_KEYS else v
           for k, v in port.get("replace", {}).items()}
    return dataclasses.replace(base, **rep)
