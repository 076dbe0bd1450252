"""Norm layer and fused functionals of the LLaMA path (plain PyTorch)."""
