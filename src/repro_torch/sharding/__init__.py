"""Sharding rules on ``torch.distributed`` (``repro.sharding``)."""
