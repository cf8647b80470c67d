"""The train step (``train_step.py``)."""
