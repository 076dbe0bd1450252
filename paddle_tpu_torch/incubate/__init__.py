"""Incubating functionals of the port (counterpart of
``paddle_tpu/incubate``)."""
