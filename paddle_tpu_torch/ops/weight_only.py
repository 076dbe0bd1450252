"""The weight-only product (``csrc/weight_only_linear.cu``, kernel C) and
its plain version.

``weight_only_matmul(x, codes, scale, int4, k)`` computes x @ dequant(W)^T
for x [..., k] (f32 or bf16) and W's codes in the port's layout, row n the
output channel (``nn.Linear``'s [out, in]): int8 codes [N, k], or int4
codes [N, ceil(k/2)] packed two to a byte (byte j: k = 2j in the low
nibble, 2j + 1 in the high), with one f32 scale per output channel. The
arithmetic is the reference's ``weight_only_linear``
(paddle_tpu/nn/quant/__init__.py:78-102), rounding point for rounding
point: int8 dequantizes w = q * s in x's dtype and sums x * w in f32,
rounded once to x's dtype; int4 sums the even k against the low nibbles
and the odd k against the high ones, each rounded to x's dtype, then
scales their sum. The reference has no Pallas kernel for it: XLA fuses
the dequantization into the product's operand read, which kernel C does
by hand.

A CPU ``x`` runs the plain version (``_wo_math``). A CUDA ``x`` of at most
``MAX_ROWS`` rows (a decode step, beam rows, a speculative verify block)
launches kernel C (counted in ``weight_only_matmul.launches``); a CUDA
``x`` of more rows (a prefill) takes the plain form, the dequantized
weight then ``torch.mm``, a product the reference also computes outside
any Pallas kernel (counted in ``weight_only_matmul.plain_calls``). There
is no fallback: a CUDA call in the kernel's range launches it or raises.
"""
import ctypes
import functools

import torch

from ..incubate.nn.functional import _mm_f32
from . import _build

MAX_ROWS = 64    # csrc/weight_only_linear.cu: kMaxRows
_BLOCK_N = 32                # its kBlockN
_TARGET_BLOCKS = 264         # two blocks on each of the H100's 132 SMs
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 2)


def _splits(n, k):
    """How many blocks share each column block's K (the bf16 kernel): as
    many as bring the grid to two blocks an SM, at most eight and at most
    one a chunk of 256 x values (its chunk_bytes)."""
    blocks = -(-n // _BLOCK_N)
    return max(1, min(-(-k // 256), 8, -(-_TARGET_BLOCKS // blocks)))


def int4_planes(codes):
    """Packed int4 codes [N, Kp] -> (low, high) nibbles [N, Kp] int8,
    sign-extended as the reference extends them: (q << 4) >> 4 and q >> 4
    on int8."""
    return (codes << 4) >> 4, codes >> 4


def _mm(a, b_t, dtype):
    """a @ b_t^T summed in f32 and rounded once to ``dtype``."""
    return _mm_f32(a, b_t.t()).to(dtype)


def _wo_math(x, codes, scale, int4, k):
    """Plain version: the reference's arithmetic as PyTorch operations."""
    dt = x.dtype
    x2 = x.reshape(-1, k)
    if int4:
        lo, hi = int4_planes(codes)
        x_lo, x_hi = x2[:, 0::2], x2[:, 1::2]
        y = (_mm(x_lo, lo[:, :x_lo.shape[1]].to(dt), dt)
             + _mm(x_hi, hi[:, :x_hi.shape[1]].to(dt), dt))
        y = y * scale.to(dt)
    else:
        y = _mm(x2, codes.to(dt) * scale.to(dt)[:, None], dt)
    return y.reshape(*x.shape[:-1], codes.shape[0])


@functools.cache
def _kernel():
    """Kernel C's C entry (the library is built and loaded once)."""
    return _build.entry("weight_only_linear", "weight_only_linear_launch",
                        _ARGTYPES)


def _check_operands(x, x2, codes, scale, int4, k):
    """Raise ValueError naming the operand kernel C does not take."""
    name, chk = "weight_only_linear", _build.check
    chk(x.is_cuda, name, "x must be a CUDA tensor")
    chk(str(x.dtype) in _build.DTYPE_CODES, name,
        f"dtype {x.dtype} not in {sorted(_build.DTYPE_CODES)}")
    chk(0 < x2.shape[0] <= MAX_ROWS, name,
        f"{x2.shape[0]} rows, not 1..{MAX_ROWS}")
    chk(codes.dtype == torch.int8 and codes.dim() == 2
        and codes.shape[1] == ((k + 1) // 2 if int4 else k), name,
        f"codes must be int8 [N, {'ceil(K/2)' if int4 else 'K'}]")
    chk(scale.dtype == torch.float32
        and tuple(scale.shape) == (codes.shape[0],), name,
        "scale must be f32 [N]")
    for t in (x2, codes, scale):
        chk(t.device == x.device, name, "operands must share x's device")
        chk(t.is_contiguous(), name, "operands must be contiguous")


def _wo_cuda(x, codes, scale, int4, k):
    """Launch kernel C on the current stream. The operands are validated
    in one expression (a decode step launches it hundreds of times, and
    the launch's host time is the step's), and on a refusal once more,
    operand by operand, for the error."""
    fn = _kernel()
    x2 = x.reshape(-1, k)
    rows, n = x2.shape[0], codes.shape[0]
    dt = _build.DTYPE_CODES.get(str(x.dtype))
    if not (x.is_cuda and dt is not None and 0 < rows <= MAX_ROWS
            and codes.dtype == torch.int8 and codes.dim() == 2
            and codes.shape[1] == ((k + 1) // 2 if int4 else k)
            and scale.dtype == torch.float32 and scale.shape == (n,)
            and codes.device == x.device and scale.device == x.device
            and x2.is_contiguous() and codes.is_contiguous()
            and scale.is_contiguous()):
        _check_operands(x, x2, codes, scale, int4, k)
    y = torch.empty(rows, n, dtype=x.dtype, device=x.device)
    splits = _splits(n, k) if dt == _build.DTYPE_CODES["torch.bfloat16"] \
        else 1
    part = (torch.empty(splits * (2 if int4 else 1) * rows * n,
                        dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    rc = fn(x2.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(),
            rows, n, k, int(int4), dt, splits,
            part.data_ptr() if part is not None else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_status(rc, "weight_only_linear")
    weight_only_matmul.launches += 1
    return y.view(*x.shape[:-1], n)


def weight_only_matmul(x, codes, scale, int4, k):
    """x [..., k] @ dequant(codes, scale)^T -> [..., N] in x's dtype (the
    module docstring)."""
    if x.device.type == "cpu":
        return _wo_math(x, codes, scale, int4, k)
    if x.numel() // k > MAX_ROWS:
        weight_only_matmul.plain_calls += 1
        return _wo_math(x, codes, scale, int4, k)
    return _wo_cuda(x, codes, scale, int4, k)


weight_only_matmul.launches = 0
weight_only_matmul.plain_calls = 0
