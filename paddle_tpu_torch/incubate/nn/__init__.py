"""Incubating functionals (counterpart of ``paddle_tpu/incubate/nn``)."""
