"""RMSNorm layer (counterpart of ``paddle_tpu/nn/layer/norm.py::RMSNorm``)."""
import torch
from torch import nn

from .functional import rms_norm


class RMSNorm(nn.Module):
    """LLaMA-style RMS norm; weight initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
