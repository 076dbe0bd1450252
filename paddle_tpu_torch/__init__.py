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
backward (MHA and GQA) as CUDA kernels. Slice 3 extends serving: int8 KV
pools (the int8 codec, ``ops.quantization``, and int8-pool variants of the
two serving kernels), sampling (``generation``) and the prefix cache.
Slices 4 and 5 train on packed rows and under context parallelism;
slices 6 to 9 redesign the kernels for Hopper. Slice 10 ports the
training recipe: the lr schedulers, clipping, L1/L2 decay, master
weights and the other optimizer rules (``optimizer``, ``nn.clip``), AMP
(``amp``), the metrics bus and the dynamics telemetry (``utils``,
``observability``), with a multi-tensor gradient-norm kernel
(``ops.grad_norm``) and AdamW's master-weight instance. Slice 11 ports
generation on the dense caches and weight-only quantization, with a
weight-only product kernel (``ops.weight_only``). Slice 12 ports mixture
of experts on one card (``incubate.distributed.models.moe``, the MoE
LLaMA), with dispatch and combine kernels (``ops.moe_dispatch``).
Slice 13 redesigns the weight-only product for Hopper. Slice 14 completes
the serving engine (``inference.continuous``: the ``ragged=False``
ladder, per-request LoRA adapters with their registry in ``serving``,
sampling overrides, ``warmup``, the online and handoff hooks) and ports
the Predictor and Config (``inference``). Slice 15 ports the online
serving control plane (``serving.ServingFrontend`` with its scheduler,
router, brownout, breaker, tenancy, handoff transports and KV fabric) and
the observability it reads; slice 16 its operator plane (the replica
supervisor with its generation fences, ``/statusz``, the hang watchdog,
the flight recorder, the fleet snapshots). Slice 17 runs fp16 through
training and serving (fp16 instances of the flash, AdamW, gradient-norm
and paged kernels, so ``amp.decorate(level="O2", dtype="float16")`` with
the dynamic ``amp.GradScaler`` trains on the card and the engine serves
an fp16 model from fp16 pools), and ports ``optimizer.LBFGS``, the flag
registry and dtype names (``framework``) and ``amp.debugging``.
"""
from . import device, framework
from .framework.dtype import (
    bfloat16, bool, complex64, complex128, finfo, float16, float32, float64,
    get_default_dtype, iinfo, int8, int16, int32, int64, set_default_dtype,
    uint8,
)
from .framework.flags import get_flags, set_flags

__all__ = ["device", "framework", "set_flags", "get_flags",
           "get_default_dtype", "set_default_dtype", "iinfo", "finfo",
           "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128"]
