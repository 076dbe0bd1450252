"""Device resolution for the port's entry points, and device constants.

Entry points take ``device=`` (default ``"cuda"``). The port runs on the
card unless the caller asks for the CPU by name; it never moves to the CPU
on its own.
"""
import torch

_CONSTANTS = {}


def constant(value, like):
    """A 0-dim tensor holding ``value`` in ``like``'s dtype and device,
    made once. Dividing by (or into) a tensor is a true division, where a
    Python-number divisor is a reciprocal-multiply on CUDA; making the
    tensor once keeps a host-to-device copy, which synchronizes the
    stream, off every call."""
    key = (value, like.dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(value, dtype=like.dtype,
                                           device=like.device)
    return t


def resolve(device="cuda"):
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
