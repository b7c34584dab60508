"""Launchers (``repro.launch``): the token server and the training loop."""
