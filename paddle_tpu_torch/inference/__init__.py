"""paddle.inference parity (counterpart of ``paddle_tpu/inference``):
``Config``, ``create_predictor``, ``Predictor`` with its zero-copy input
and output handles, and the continuous-batching engine."""
from .config import Config
from .continuous import ContinuousBatchingEngine
from .predictor import AotPredictor, Predictor, create_predictor

__all__ = ["AotPredictor", "Config", "ContinuousBatchingEngine", "Predictor",
           "create_predictor"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


class PlaceType:
    kHOST = 0
    kCPU = 0
    kGPU = 1
    kXPU = 2
    kCUSTOM = 3
