"""The int8 KV codec (the port's own copy of the quantization utilities of
jax's Pallas paged-attention kernel, as ``paddle_tpu/ops/paged_attention.py``
uses them).

A quantized pool is a ``QuantizedTensor(weight, scales)`` pair: int8 codes
``[Hkv, P, bs, D]`` and one f32 scale per row ``[Hkv, P, bs, 1]``, the
row's absolute maximum. A value is ``code * scale / 127.5``.

The reference's encoder is ``int8(rint(x * (127.5 / absmax)))`` under XLA,
whose float -> int8 cast saturates and sends NaN to 0. torch's cast does
neither (it wraps and truncates, and a NaN's code is unspecified on CUDA),
so ``quantize_to_int8`` rounds half to even, clamps to [-128, 127] and
zeroes NaN (an all-zero row: ``0 * inf``) before it casts. The codes and
scales then match the reference's bit for bit, on the CPU and on the card.
"""
from typing import NamedTuple

import torch

from ..device import constant

MAX_INT8 = 127.5


class QuantizedTensor(NamedTuple):
    """int8 codes and their per-row f32 scales."""

    weight: torch.Tensor
    scales: torch.Tensor


def is_quantized(pages):
    """True for the int8 pool form, a QuantizedTensor(weight, scales)."""
    return isinstance(pages, QuantizedTensor)


def quantize_to_int8(x):
    """x (float) -> QuantizedTensor: scales = max |x| over the last axis
    (kept as a size-1 axis), codes = int8(rint(x * (127.5 / scales)))
    with XLA's saturating, NaN-to-0 cast."""
    scales = x.abs().amax(dim=-1, keepdim=True)
    # a true division: ``127.5 / tensor`` is torch's reciprocal-multiply,
    # which can round a row's absmax element to the other side of 127.5
    v = torch.round(x * (constant(MAX_INT8, scales) / scales))
    v = v.clamp_(-128.0, 127.0).nan_to_num_(nan=0.0)
    return QuantizedTensor(weight=v.to(torch.int8), scales=scales)


def from_int8(weight, scales, dtype=torch.float32):
    """Codes -> values: ``weight.to(dtype) * scales / 127.5``, multiplied
    first and divided second, in the reference's order (by a tensor: a
    Python-number divisor is a reciprocal-multiply on CUDA)."""
    v = weight.to(dtype) * scales
    return v / constant(MAX_INT8, v)


def quantize_pages(pages):
    """Float pool -> int8 QuantizedTensor pool (per-row absmax scales of
    the f32 upcast)."""
    return quantize_to_int8(pages.float())
