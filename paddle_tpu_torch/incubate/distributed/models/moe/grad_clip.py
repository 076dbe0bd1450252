"""MoE-aware global-norm clip (counterpart of
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``).

The reference splits the global norm into ordinary and expert parameters
because each rank of an expert group holds other experts. On one card
every expert is local, so the two parts are one norm over all gradients:
``ClipGradByGlobalNorm``'s (one launch of the gradient-norm kernel on the
card). The class keeps the reference's signature and its
``is_expert_param`` partition.
"""
from .....nn.clip import ClipGradByGlobalNorm


def is_expert_param(p):
    """Both of the reference's flags set. (A torch tensor has a method
    named ``is_distributed``: only the flag ``True`` counts.)"""
    return (getattr(p, "is_distributed", False) is True
            and getattr(p, "no_sync", False) is True)


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__(clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func or is_expert_param
        self.moe_group = moe_group
