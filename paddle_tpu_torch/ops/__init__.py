"""Attention ops of the serving path, each with a hand-written CUDA kernel
(``csrc/``, built by ``_build``) and its plain PyTorch version."""
