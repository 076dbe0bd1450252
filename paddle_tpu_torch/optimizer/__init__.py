"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``; slice 2:
the base class, Adam and AdamW)."""
from .optimizer import L2Decay, Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "L2Decay", "Adam", "AdamW"]
