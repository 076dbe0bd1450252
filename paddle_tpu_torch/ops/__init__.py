"""Attention ops of the serving and training paths and the training
step's own (the AdamW update, ``adamw``; the multi-tensor gradient norm,
``grad_norm``), each with a hand-written CUDA kernel (``csrc/``, built by
``_build``) and its plain PyTorch version; the int8 KV codec of the
serving pools (``quantization``); the weight-only product
(``weight_only``); the MoE dispatch and combine (``moe_dispatch``)."""
