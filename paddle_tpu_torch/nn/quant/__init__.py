"""Weight-only quantization for inference (counterpart of
``paddle_tpu/nn/quant/__init__.py``).

Weights are stored as int8 codes, or int4 codes packed two to a byte, with
one f32 absmax scale per output channel; the product reads the codes and
dequantizes them on the way (``ops.weight_only``: kernel C on the card),
so a decode step reads 1 (or 0.5) byte a weight instead of bf16's 2.

Layouts. ``weight_quantize`` and ``weight_dequantize`` keep the
reference's: a float weight [K, N] (``x @ W``), int8 codes [K, N], int4
codes [ceil(K/2), N] with rows 2j and 2j + 1 in byte j's low and high
nibble, scales [N]. ``WeightOnlyLinear`` stores its codes in the port's
``nn.Linear`` layout instead, a row per output channel (int8 [N, K], int4
[N, ceil(K/2)] with the same pairing): the transpose of the reference's,
which ``models.convert`` converts at the boundary. ``weight_only_linear``
takes codes in that layout.

The codes and scales are the reference's bit for bit: absmax / 127 (int4:
/ 7) and w / max(scale, 1e-30) are true f32 divisions (a Python-number
divisor is a reciprocal-multiply on CUDA), rounding is half to even, int8
clips to +-127 and int4 to +-7.
"""
import torch
from torch import nn

from ...device import constant
from ...ops.weight_only import int4_planes, weight_only_matmul

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_inference"]

_ALGOS = {"weight_only_int8": False, "weight_only_int4": True}


def _is_int4(algo):
    if algo not in _ALGOS:
        raise ValueError(f"unsupported algo {algo!r}")
    return _ALGOS[algo]


def quantize_rows(w, int4=False):
    """A float weight [N, K] (a row per output channel) -> (codes int8 [N,
    K], or int4 packed [N, ceil(K/2)]; scales f32 [N])."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=1)
    qmax = 7.0 if int4 else 127.0
    scale = absmax / constant(qmax, absmax)
    q = torch.clamp(torch.round(w / torch.clamp_min(scale, 1e-30)[:, None]),
                    -qmax, qmax).to(torch.int8)
    if not int4:
        return q, scale
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    u = q.view(torch.uint8)
    packed = ((u[:, 1::2] & 0xF) << 4) | (u[:, 0::2] & 0xF)
    return packed.view(torch.int8).contiguous(), scale


def unpack_rows(codes, k):
    """Packed int4 codes [N, ceil(K/2)] -> int8 codes [N, K] in [-8, 7]."""
    lo, hi = int4_planes(codes)
    return torch.stack([lo, hi], dim=2).reshape(codes.shape[0], -1)[:, :k]


def dequantize_rows(codes, scale, int4=False, k=None, dtype=torch.float32):
    """(codes [N, K | ceil(K/2)], scales [N]) -> q * s in f32, cast to
    ``dtype``, [N, K]."""
    if int4:
        codes = unpack_rows(codes, k if k is not None else 2 * codes.shape[1])
    return (codes.float() * scale[:, None]).to(dtype)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """[K, N] float weight -> (codes, [N] f32 scale) in the reference's
    layout (reference :25). ``arch`` and ``group_size`` are accepted and
    select nothing, as in the reference."""
    codes, scale = quantize_rows(torch.as_tensor(x).t(), _is_int4(algo))
    return codes.t().contiguous(), scale


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float32", k=None):
    """The reference's layout back to a float weight [K, N] (reference
    :61): q * scale in f32, cast to ``out_dtype``."""
    dtype = getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype
    codes = torch.as_tensor(x).t().contiguous()
    return dequantize_rows(codes, torch.as_tensor(scale), _is_int4(algo), k,
                           dtype).t()


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """y = x @ dequant(weight) (+ bias), reference :70, with ``weight`` the
    codes in ``WeightOnlyLinear``'s layout (int8 [N, K], int4 [N,
    ceil(K/2)]) and ``weight_scale`` [N]; K is x's last dim. The product is
    ``ops.weight_only.weight_only_matmul``; the bias is added after it, in
    x's dtype (reference :100-102)."""
    int4 = str(weight_dtype) == "int4"
    y = weight_only_matmul(x, weight, weight_scale, int4, x.shape[-1])
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class WeightOnlyLinear(nn.Module):
    """Inference replacement for a trained ``nn.Linear`` (reference :107):
    its int8 or int4 codes and scales are buffers (no gradients, no
    optimizer state), and ``forward`` runs ``weight_only_linear``."""

    def __init__(self, linear, weight_dtype="int8"):
        super().__init__()
        self.weight_dtype = str(weight_dtype)
        codes, scale = quantize_rows(linear.weight,
                                     self.weight_dtype == "int4")
        self.in_features = linear.weight.shape[1]
        self.out_features = linear.weight.shape[0]
        self.register_buffer("quant_weight", codes)
        self.register_buffer("weight_scale", scale)
        self.bias = getattr(linear, "bias", None)

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, self.bias,
                                  self.weight_scale, self.weight_dtype)

    @property
    def weight(self):
        """The dequantized f32 weight [out, in] (reference :127-133: what
        ``init_cache`` probes for its dtype), not what ``forward`` reads."""
        return dequantize_rows(self.quant_weight, self.weight_scale,
                               self.weight_dtype == "int4", self.in_features)


def quantize_for_inference(model, weight_dtype="int8",
                           skip=lambda name, layer: False):
    """Swap every ``nn.Linear`` of ``model`` for a ``WeightOnlyLinear`` in
    place, unless ``skip(name, layer)`` (name as in ``named_modules``, e.g.
    "lm_head") keeps it; returns the model (reference :136)."""

    def convert(parent, prefix=""):
        for name, child in list(parent.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(child, nn.Linear) and not skip(full, child):
                setattr(parent, name, WeightOnlyLinear(child, weight_dtype))
            else:
                convert(child, full)

    convert(model)
    return model
