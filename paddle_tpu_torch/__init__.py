"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package keeps its
file and public names so that each counterpart is easy to find. It imports
``torch``, numpy and the standard library only. Its CUDA kernels
(``ops/csrc``) are hand-written for Hopper and built at first use; on a CPU
tensor every kernel wrapper runs its plain PyTorch version.

Slice 1 ports the serving path: LLaMA through the ragged continuous-
batching engine (``inference.continuous``), with ragged paged attention
and paged decode attention as CUDA kernels. Slice 2 ports the training
path: ``jit_api.TrainStep`` over ``LlamaForCausalLM`` with recompute, the
fused linear cross-entropy and AdamW, and flash attention forward and
backward (MHA and GQA) as CUDA kernels.
"""
from . import device

__all__ = ["device"]
