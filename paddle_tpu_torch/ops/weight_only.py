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
import collections
import ctypes
import functools

import torch

from ..incubate.nn.functional import _mm_f32
from ..framework.nan_inf import checked
from . import _build

MAX_ROWS = 64    # csrc/weight_only_linear.cu: kMaxRows
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])

# The bf16 kernel's launch plan, mirroring csrc/weight_only_linear.cu's
# constants: a block owns 64 or 128 output channels (TN) and walks its
# share of K in UNIT_BYTES code bytes a row at a time (one stage of its
# ring).
TILE_N = 128           # a block's channels, at most
TILE_SIZES = (128, 64)
UNIT_BYTES = 128       # kUnitBytes
MAX_SPLITS = 8         # kMaxSplits: a portable thread block cluster
MAX_STAGES = 24        # kMaxStages
SMEM_LIMIT = 232448    # kSmemLimit: an H100 block's shared memory
# clusters of each size an H100 holds at once, one block an SM (its shared
# memory): cudaOccupancyMaxActiveClusters on the card; the GPCs' SM counts
# leave some SMs out of the larger clusters
ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
_RAMP_UNITS = 4        # a wave's fill and drain, in units of one block
_REDUCE_UNITS = 1      # the cluster's sum through distributed memory

Plan = collections.namedtuple(
    "Plan", "nt tile_n tiles units splits stages stage_bytes smem_bytes "
    "warpgroups")


def unit_k(int4):
    """x values (k) one unit of a code row covers: 128 int8 codes, or 256
    int4 codes packed in 128 bytes."""
    return 2 * UNIT_BYTES if int4 else UNIT_BYTES


@functools.lru_cache(maxsize=None)
def plan(rows, n, k, int4):
    """The bf16 kernel's launch for x [rows, k] against N = ``n`` channels,
    from the shapes alone:
    - ``nt``: x's rows rounded up to 8, wgmma's N (the instance);
    - ``tile_n`` and ``tiles``: a block's channels (64 or 128) and the
      blocks along N;
    - ``units``: UNIT_BYTES pieces of a code row;
    - ``splits``: blocks of a cluster along K, block r summing units
      [units r / splits, units (r + 1) / splits). The tile and the split
      are the pair that minimises the waves of clusters (ACTIVE_CLUSTERS
      at a time) times a block's work, its units times tile_n / 128, plus
      a wave's ramp and the cluster's sum; the wider tile and then the
      fewer blocks on a tie;
    - ``stages``: the ring's depth, as many as fit the block's shared
      memory, at most MAX_STAGES and at most a block's units (at least 2);
    - ``stage_bytes`` and ``smem_bytes``: csrc's stage_bytes and
      hopper_smem_bytes;
    - ``warpgroups``: the block's consumer warpgroups (csrc's
      consumer_wgs: 6 at nt 8, 4 up to nt 32 int8 or 24 int4, else 2), in
      groups of tile_n / 64 that take turns at the stages."""
    nt = 8 * -(-rows // 8)
    row_bytes = (k + 1) // 2 if int4 else k
    units = -(-row_bytes // UNIT_BYTES)

    def cost(tile_n, splits):
        tiles = -(-n // tile_n)
        waves = -(-tiles // ACTIVE_CLUSTERS[splits])
        return (waves * (-(-units // splits) * tile_n / TILE_N + _RAMP_UNITS)
                + (_REDUCE_UNITS if splits > 1 else 0))

    tile_n, splits = min(((t, s) for t in TILE_SIZES
                          for s in range(1, min(MAX_SPLITS, units) + 1)),
                         key=lambda ts: (cost(*ts), -ts[0], ts[1]))
    stage = tile_n * UNIT_BYTES + unit_k(int4) // 64 * nt * 128
    fit = (SMEM_LIMIT - 1024) // (stage + 16)
    stages = max(2, min(MAX_STAGES, -(-units // splits), fit))
    warpgroups = 6 if nt <= 8 else 4 if nt <= (24 if int4 else 32) else 2
    return Plan(nt, tile_n, -(-n // tile_n), units, splits, stages, stage,
                1024 + stages * (stage + 16), warpgroups)


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
        # one kernel: the int8 codes meet the scale in x's dtype (exact, as
        # codes.to(dt)), so no dequantized copy of the codes is made first
        y = _mm(x2, codes * scale.to(dt)[:, None], dt)
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
    _build.check_dtype(name, x, _build.F32_BF16_CODES)
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


_BF16 = _build.DTYPE_CODES["torch.bfloat16"]


def _wo_cuda(x, codes, scale, int4, k):
    """Launch kernel C on the current stream (bf16 x: by ``plan``). The
    operands are validated in one expression (a decode step launches it
    hundreds of times, and the launch's host time is the step's), and on a
    refusal once more, operand by operand, for the error."""
    fn = _kernel()
    x2 = x.reshape(-1, k)
    rows, n = x2.shape[0], codes.shape[0]
    dt = _build.F32_BF16_CODES.get(str(x.dtype))
    if not (x.is_cuda and dt is not None and 0 < rows <= MAX_ROWS
            and codes.dtype == torch.int8 and codes.dim() == 2
            and codes.shape[1] == ((k + 1) // 2 if int4 else k)
            and scale.dtype == torch.float32 and scale.shape == (n,)
            and codes.device == x.device and scale.device == x.device
            and x2.is_contiguous() and codes.is_contiguous()
            and scale.is_contiguous()):
        _check_operands(x, x2, codes, scale, int4, k)
    y = torch.empty(rows, n, dtype=x.dtype, device=x.device)
    p = plan(rows, n, k, int4) if dt == _BF16 else None
    rc = fn(x2.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(),
            rows, n, k, int(int4), dt, p.splits if p else 1,
            p.stages if p else 0, p.tile_n if p else 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_status(rc, "weight_only_linear")
    _build.count_launch(weight_only_matmul)
    return y.view(*x.shape[:-1], n)


@checked("weight_only_linear")
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
