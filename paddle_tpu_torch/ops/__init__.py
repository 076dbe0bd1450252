"""Attention ops of the serving and training paths, each with a
hand-written CUDA kernel (``csrc/``, built by ``_build``) and its plain
PyTorch version."""
