"""Mixture of experts on one card (counterpart of
``paddle_tpu/incubate/distributed/models/moe``)."""
from .gate import (  # noqa: F401
    BaseGate, GShardGate, NaiveGate, SwitchGate, route, top_k_dispatch,
)
from .grad_clip import ClipGradForMOEByGlobalNorm, is_expert_param  # noqa: F401
from .moe_layer import (  # noqa: F401
    ExpertStack, MoE, MoELayer, SwiGLUExpertStack,
)
