"""Checkpoints of training state (``repro.checkpoint``)."""
