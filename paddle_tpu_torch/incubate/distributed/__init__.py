"""Distributed extras of the incubating API (counterpart of
``paddle_tpu/incubate/distributed``)."""
from . import models  # noqa: F401
