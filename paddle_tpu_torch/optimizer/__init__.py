"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``): the
base class with schedulers, clipping, L1/L2 decay, param groups and master
weights, the thirteen rules, the closure-driven ``LBFGS`` and the
learning-rate schedulers (``lr``)."""
from . import lr
from ..regularizer import L1Decay, L2Decay
from .lbfgs import LBFGS
from .optimizer import Optimizer
from .optimizers import (
    ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum, NAdam,
    RAdam, RMSProp, Rprop,
)

__all__ = ["lr", "Optimizer", "L1Decay", "L2Decay", "SGD", "Momentum",
           "Adam", "AdamW", "Adagrad", "RMSProp", "Adadelta", "Adamax",
           "Lamb", "NAdam", "RAdam", "Rprop", "ASGD", "LBFGS"]
