"""Device resolution for the port's entry points.

Entry points take ``device=`` (default ``"cuda"``). The port runs on the
card unless the caller asks for the CPU by name; it never moves to the CPU
on its own.
"""
import torch


def resolve(device="cuda"):
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
