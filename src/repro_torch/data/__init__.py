"""The synthetic data pipeline (``repro.data``)."""
