"""The MoE layer's token dispatch and combine (``csrc/moe_dispatch.cu``,
kernels D and E) on compact routing, and their plain versions.

The reference builds dense one-hot tensors ``combine`` and ``dispatch``
[T, E, C] in its gate and moves tokens with two einsums
(paddle_tpu/incubate/distributed/models/moe/moe_layer.py:149, :163); XLA
computes them, there is no Pallas kernel. The port keeps a ``Routing``:
per token and choice the slot ``e * C + c`` it landed in (-1 when
dropped) and its kept weight. Then

- ``moe_dispatch(tokens, routing)`` -> [E, C, M]: each slot holds its
  token's row, an empty slot a zero row (the reference's
  ``einsum('tec,tm->ecm', dispatch, tokens)``);
- ``moe_combine(expert_out, routing)`` -> [T, M]: each token's weighted
  sum of its kept slots' rows (``einsum('tec,ecm->tm', combine,
  expert_out)``).

A CPU tensor runs the plain version: the reference's einsums over the
dense tensors that ``Routing.dense`` builds from the same routing, with
autograd through them. A CUDA tensor goes through two
``torch.autograd.Function``s whose forward and backward are the kernels:
D gathers rows (the dispatch, and the combine's gradient to the expert
outputs scaled by each slot's weight), E sums weighted rows (the combine,
and the dispatch's gradient to the tokens with unit weights), and E's
weight gradient takes one f32 row dot product a (token, choice). Each
raw wrapper counts its launches (``dispatch_rows.launches``,
``combine_rows.launches``, ``combine_dw.launches``). There is no fallback:
an operand the kernels do not take (dtype, a row width M * itemsize not a
multiple of 16 bytes, more than ``MAX_K`` choices) raises.
"""
import ctypes
import functools

import torch

from ..framework.nan_inf import checked
from . import _build

MAX_K = 8          # csrc/moe_dispatch.cu: kMaxK
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries' signatures: pointers and the stream as c_void_p
_GATHER_ARGS = (_P,) * 4 + (_I,) * 3 + (_P,)
_ROWS_ARGS = (_P,) * 4 + (_I,) * 4 + (_P,)   # combine and its weight grad


class Routing:
    """Compact top-k routing of T tokens over E experts of capacity C.

    - ``expert`` [T, k] int64: each choice's expert, best first;
    - ``pos`` [T, k] int32: its position in the expert's queue (all first
      choices queue before any second choice, in token order);
    - ``slot`` [T, k] int32: ``expert * C + pos`` where ``pos < C`` (the
      choice is kept), else -1;
    - ``weight`` [T, k]: the normalized gate value where kept, else 0, in
      the probabilities' dtype (differentiable);
    - ``aux``: the load-balancing loss.

    A kept choice whose weight is 0 still takes its position, but its slot
    stays empty (the reference's ``dispatch = combine > 0``)."""

    def __init__(self, expert, pos, slot, weight, aux, num_expert, capacity):
        self.expert, self.pos, self.slot = expert, pos, slot
        self.weight, self.aux = weight, aux
        self.num_expert, self.capacity = num_expert, capacity
        self.top_k = slot.shape[1]

    @property
    def num_slots(self):
        return self.num_expert * self.capacity

    @functools.cached_property
    def occupied_slot(self):
        """[T, k] int32: the slot where the choice's token is dispatched
        (kept with a weight > 0), else -1."""
        return torch.where(self.weight.detach() > 0, self.slot,
                           -1).to(torch.int32).contiguous()

    @functools.cached_property
    def dispatch_src(self):
        """[E * C] int32: each slot's dispatched token, or -1 (empty)."""
        slot = self.occupied_slot
        T, k = slot.shape
        R = self.num_slots
        tok = torch.arange(T, dtype=torch.int32, device=slot.device)
        idx = torch.where(slot >= 0, slot, R).long().reshape(-1)
        src = torch.full((R + 1,), -1, dtype=torch.int32, device=slot.device)
        src.scatter_(0, idx, tok.repeat_interleave(k))
        return src[:R].contiguous()

    def dense(self):
        """The reference's (combine [T, E, C], dispatch [T, E, C]) in the
        weights' dtype; combine is differentiable in ``weight``."""
        T, k = self.slot.shape
        R = self.num_slots
        idx = torch.where(self.slot >= 0, self.slot, R).long()
        combine = torch.zeros(T, R + 1, dtype=self.weight.dtype,
                              device=self.weight.device).scatter(
                                  1, idx, self.weight)[:, :R]
        combine = combine.reshape(T, self.num_expert, self.capacity)
        return combine, (combine > 0).to(combine.dtype)


# ---- plain versions ---------------------------------------------------------
def _dispatch_math(tokens, routing):
    """The reference's dispatch einsum over the dense routing."""
    _, dispatch = routing.dense()
    return torch.einsum("tec,tm->ecm", dispatch, tokens)


def _combine_math(expert_out, routing):
    """The reference's combine einsum over the dense routing."""
    combine, _ = routing.dense()
    return torch.einsum("tec,ecm->tm", combine, expert_out)


# ---- the kernels' wrappers ---------------------------------------------------
@functools.cache
def _entry(symbol, argtypes):
    return _build.entry("moe_dispatch", symbol, argtypes)


def _check_rows(name, x, *index):
    """Raise ValueError for an operand the kernels do not take."""
    chk = _build.check
    chk(x.is_cuda, name, "rows must be a CUDA tensor")
    _build.check_dtype(name, x, _build.F32_BF16_CODES)
    chk(x.dim() == 2 and x.shape[1] * x.element_size() % 16 == 0, name,
        f"rows [n, M] with M * itemsize a multiple of 16 bytes, got "
        f"{tuple(x.shape)} {x.dtype}")
    for t in (x, *index):
        chk(t.device == x.device, name, "operands must share a device")
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0 or t.numel() == 0, name,
            "operands must be 16-byte aligned")
    for t in index:
        chk(t.dtype in (torch.int32, torch.float32), name,
            "indices int32 and weights f32")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


@checked("moe_dispatch")
def dispatch_rows(x, src, scale=None):
    """Kernel D: out[s] = x[src[s]] (times ``scale[s]`` in f32, rounded
    once) or a zero row where ``src[s] < 0``. x [n, M], src [R] int32,
    scale [R] f32 or None -> [R, M] in x's dtype."""
    name = "moe_dispatch_rows"
    fn = _entry("moe_gather_rows_launch", _GATHER_ARGS)
    _check_rows(name, x, src, *(() if scale is None else (scale,)))
    out = torch.empty(src.shape[0], x.shape[1], dtype=x.dtype,
                      device=x.device)
    rc = fn(x.data_ptr(), src.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            src.shape[0], x.shape[1], _build.DTYPE_CODES[str(x.dtype)],
            _stream(x))
    _build.check_status(rc, name)
    _build.count_launch(dispatch_rows)
    return out


@checked("moe_combine")
def combine_rows(x, slot, w=None):
    """Kernel E: out[t] = sum_j w[t, j] x[slot[t, j]] over the choices with
    slot >= 0, in f32, rounded once (unit weights when ``w`` is None). x
    [n, M], slot [T, k] int32, w [T, k] f32 -> [T, M]."""
    name = "moe_combine_rows"
    fn = _entry("moe_combine_rows_launch", _ROWS_ARGS)
    _check_rows(name, x, slot, *(() if w is None else (w,)))
    _build.check(0 < slot.shape[1] <= MAX_K, name,
                 f"{slot.shape[1]} choices, not 1..{MAX_K}")
    T, k = slot.shape
    out = torch.empty(T, x.shape[1], dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), slot.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), T, k,
            x.shape[1], _build.DTYPE_CODES[str(x.dtype)], _stream(x))
    _build.check_status(rc, name)
    _build.count_launch(combine_rows)
    return out


@checked("moe_combine_dw")
def combine_dw(dout, x, slot):
    """E's weight gradient: dw[t, j] = <dout[t], x[slot[t, j]]> in f32, 0
    where slot < 0. dout [T, M], x [n, M], slot [T, k] int32 -> [T, k]
    f32."""
    name = "moe_combine_dw"
    fn = _entry("moe_combine_dw_launch", _ROWS_ARGS)
    _check_rows(name, x, slot)
    _check_rows(name, dout)
    _build.check(dout.dtype == x.dtype and dout.shape[1] == x.shape[1], name,
                 "dout and rows must share dtype and width")
    _build.check(0 < slot.shape[1] <= MAX_K, name,
                 f"{slot.shape[1]} choices, not 1..{MAX_K}")
    T, k = slot.shape
    dw = torch.empty(T, k, dtype=torch.float32, device=x.device)
    rc = fn(dout.data_ptr(), x.data_ptr(), slot.data_ptr(), dw.data_ptr(),
            T, k, x.shape[1], _build.DTYPE_CODES[str(x.dtype)], _stream(x))
    _build.check_status(rc, name)
    _build.count_launch(combine_dw)
    return dw


dispatch_rows.launches = 0
combine_rows.launches = 0
combine_dw.launches = 0


class _Dispatch(torch.autograd.Function):
    """D forward; its gradient to the tokens is E with unit weights over
    each token's occupied slots."""

    @staticmethod
    def forward(ctx, tokens, src, occupied_slot):
        ctx.save_for_backward(occupied_slot)
        return dispatch_rows(tokens, src)

    @staticmethod
    def backward(ctx, grad):
        (occupied_slot,) = ctx.saved_tensors
        return combine_rows(grad.contiguous(), occupied_slot), None, None


class _Combine(torch.autograd.Function):
    """E forward; its gradients: D scaled by each slot's weight to the
    expert outputs, and the row dot products to the weights."""

    @staticmethod
    def forward(ctx, expert_out, weight, slot, dispatch_src):
        w = weight.float().contiguous()
        ctx.save_for_backward(expert_out, w, slot, dispatch_src)
        ctx.weight_dtype = weight.dtype
        return combine_rows(expert_out, slot, w)

    @staticmethod
    def backward(ctx, grad):
        expert_out, w, slot, dispatch_src = ctx.saved_tensors
        grad = grad.contiguous()
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            # a kept choice of weight 0 leaves its slot empty in
            # dispatch_src: its gradient row is 0 either way
            R = dispatch_src.shape[0]
            idx = torch.where(slot >= 0, slot, R).long().reshape(-1)
            w_slot = torch.zeros(R + 1, dtype=torch.float32,
                                 device=w.device).scatter_(0, idx,
                                                           w.reshape(-1))
            d_x = dispatch_rows(grad, dispatch_src, w_slot[:R].contiguous())
        if ctx.needs_input_grad[1]:
            d_w = combine_dw(grad, expert_out, slot).to(ctx.weight_dtype)
        return d_x, d_w, None, None


def moe_dispatch(tokens, routing):
    """tokens [T, M] -> [E, C, M] (the module docstring)."""
    if tokens.device.type == "cpu":
        return _dispatch_math(tokens, routing)
    out = _Dispatch.apply(tokens.contiguous(), routing.dispatch_src,
                          routing.occupied_slot)
    return out.view(routing.num_expert, routing.capacity, tokens.shape[1])


def moe_combine(expert_out, routing):
    """expert_out [E, C, M] -> [T, M] (the module docstring)."""
    if expert_out.device.type == "cpu":
        return _combine_math(expert_out, routing)
    x = expert_out.reshape(routing.num_slots, expert_out.shape[-1])
    return _Combine.apply(x.contiguous(), routing.weight,
                          routing.slot, routing.dispatch_src)
