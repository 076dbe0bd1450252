"""The multi-tensor gradient norm (``csrc/grad_norm.cu``, kernel A) and its
plain version.

``grad_sumsq(tensors, scale=None, clip_norm=None, groups=None)`` reads a
list of f32, bf16 or fp16 tensors once and returns ``SumSq``: per tensor
the f32 sum of squares of ``t / scale`` and a flag that some element of it
is NaN or Inf; per group (``groups[i]`` is tensor i's group index, or -1)
the sums and flags; the total, its square root and, given ``clip_norm``,
ClipGradByGlobalNorm's factor ``min(1, clip / max(norm, 1e-12))``, all on
the tensors' device. The reference computes the same inside its compiled
step (the unscale and finite check of paddle_tpu/jit_api.py:328-337, the
global norm of paddle_tpu/nn/clip.py:55-66, the dynamics' grad_sq and
nf_mask); it has no Pallas kernel for it.

A CUDA list launches the kernel (counted in ``grad_sumsq.launches``); a CPU
list runs ``_sumsq_math``. Both square in f32 (``t / scale`` rounded to
f32, then squared), sum a tensor in f64 and round its sum once to f32, then
add the tensors' sums in order in f32, as the reference adds them; the
kernel's order within a tensor is fixed, so two launches give the same
bits.
"""
import ctypes

import torch

from ..framework.nan_inf import checked
from . import _build

CHUNK = 65536   # elements a block reads (csrc/grad_norm.cu: kChunk)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_void_p] * 5)


class SumSq:
    """Views into one launch's outputs (see the module docstring)."""

    def __init__(self, out, flags, n_tensors, n_groups):
        n, g = n_tensors, n_groups
        self.sums, self.group_sums = out[:n], out[n:n + g]
        self.total, self.norm, self.factor = out[n + g], out[n + g + 1], \
            out[n + g + 2]
        self.nonfinite, self.group_nonfinite = flags[:n], flags[n:n + g]
        self.any_nonfinite = flags[n + g]


def _meta(tensors, groups):
    """The kernel's int64 table: ptr | numel | dtype | chunk starts |
    group, and the number of chunks."""
    starts, n_chunks = [], 0
    for t in tensors:
        starts.append(n_chunks)
        n_chunks += -(-t.numel() // CHUNK)
    rows = ([t.data_ptr() for t in tensors] + [t.numel() for t in tensors]
            + [_build.DTYPE_CODES[str(t.dtype)] for t in tensors]
            + starts + [n_chunks] + list(groups))
    return torch.tensor(rows, dtype=torch.int64), n_chunks


def _outputs(device, n, g):
    return (torch.empty(n + g + 3, dtype=torch.float32, device=device),
            torch.empty(n + g + 1, dtype=torch.int32, device=device))


def finish_math(sums, bad, groups, n_groups, clip_norm):
    """Plain version of the finishing pass: per-tensor f32 sums (0-d
    tensors) and flags (or [] for none) added in order into the total and
    each group; returns the kernel's (out, flags) layout."""
    dev = sums[0].device if sums else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    bad = list(bad) or [no] * len(sums)
    total, gsum, gbad = zero, [zero] * n_groups, [no] * n_groups
    for s, b, g in zip(sums, bad, groups):
        total = total + s
        if g >= 0:
            gsum[g] = gsum[g] + s
            gbad[g] = gbad[g] | b
    norm = total.sqrt()
    factor = torch.ones((), dtype=torch.float32, device=dev)
    if clip_norm is not None:
        factor = torch.minimum(factor, clip_norm / torch.maximum(
            norm, torch.tensor(1e-12, dtype=torch.float32, device=dev)))
    out = torch.stack(list(sums) + gsum + [total, norm, factor])
    flags = torch.stack(bad + gbad + [torch.stack(bad + [no]).any()])
    return out, flags.to(torch.int32)


def _sumsq_math(tensors, scale, clip_norm, groups, n_groups):
    """Plain version: the kernel's arithmetic as PyTorch operations."""
    sums, bad = [], []
    for t in tensors:
        x = t.float()
        if scale is not None:
            x = x / scale
        bad.append(~torch.isfinite(x).all())
        sums.append(x.square().sum(dtype=torch.float64).float())
    out, flags = finish_math(sums, bad, groups, n_groups, clip_norm)
    return SumSq(out, flags, len(tensors), n_groups)


def _sumsq_cuda(tensors, scale, clip_norm, groups, n_groups):
    """Launch the kernel on the current stream; validates every operand."""
    name = "grad_sumsq"
    fn = _build.entry("grad_norm", "grad_sumsq_launch", _ARGTYPES)
    chk = _build.check
    dev = tensors[0].device
    chk(dev.type == "cuda", name, "tensors must be CUDA tensors")
    for t in tensors:
        chk(t.device == dev, name, "tensors must share one device")
        _build.check_dtype(name, t)
        chk(t.is_contiguous(), name, "tensors must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "tensors must be 16-byte aligned")
    if scale is not None:
        chk(scale.device == dev and scale.dtype == torch.float32
            and scale.numel() == 1, name,
            "scale must be one f32 on the tensors' device")
    meta, n_chunks = _meta(tensors, groups)
    meta = meta.pin_memory().to(dev, non_blocking=True)
    part = torch.empty(n_chunks, dtype=torch.float64, device=dev)
    bad = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    out, flags = _outputs(dev, len(tensors), n_groups)
    rc = fn(meta.data_ptr(), len(tensors), n_chunks, n_groups,
            scale.data_ptr() if scale is not None else None,
            int(clip_norm is not None), float(clip_norm or 0.0),
            part.data_ptr(), bad.data_ptr(), out.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_status(rc, name)
    _build.count_launch(grad_sumsq, like=tensors)
    return SumSq(out, flags, len(tensors), n_groups)


def _results(args, kwargs, st):
    """grad_sumsq's outputs: the sums, the total, norm and factor."""
    return st.sums, st.group_sums, st.total, st.norm, st.factor


@checked("grad_sumsq", _results)
@torch.no_grad()
def grad_sumsq(tensors, scale=None, clip_norm=None, groups=None,
               n_groups=0):
    """Sums of squares, flags, total, norm and clip factor of ``tensors``
    (module docstring). ``scale``: a one-element f32 tensor on their device
    that every element is divided by first, or None. ``groups``: one group
    index (< ``n_groups``, or -1) per tensor, or None."""
    tensors = list(tensors)
    groups = [-1] * len(tensors) if groups is None else list(groups)
    if len(groups) != len(tensors):
        raise ValueError("grad_sumsq: one group index per tensor")
    if tensors and tensors[0].device.type != "cpu":
        return _sumsq_cuda(tensors, scale, clip_norm, groups, n_groups)
    return _sumsq_math(tensors, scale, clip_norm, groups, n_groups)


grad_sumsq.launches = grad_sumsq.launches_fp16 = 0
