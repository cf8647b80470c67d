"""Serving: prefill + batched decode (``engine.generate``)."""
