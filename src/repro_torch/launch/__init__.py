"""Launchers (``repro.launch``): the token server so far."""
