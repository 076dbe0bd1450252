"""Tensor functions of the port (counterpart of ``paddle_tpu/tensor``):
``linalg.matmul`` so far; the rest come later (ROADMAP.md)."""
