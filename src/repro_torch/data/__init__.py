"""Deterministic synthetic data (``pipeline.py``)."""
