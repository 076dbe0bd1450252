"""Carry a reference model's weights into the port and back."""
import numpy as np
import torch
from torch import nn

from ..nn.quant import WeightOnlyLinear


def _state(model):
    """{name: tensor} of what the conversion carries: the parameters and a
    ``WeightOnlyLinear``'s code and scale buffers; and the names stored
    transposed ([out, in] here, [in, out] in the reference): Linear
    weights and the codes."""
    state = dict(model.named_parameters())
    transposed = set()
    for n, m in model.named_modules():
        if isinstance(m, nn.Linear):
            transposed.add(f"{n}.weight")
        elif isinstance(m, WeightOnlyLinear):
            for b in ("quant_weight", "weight_scale"):
                state[f"{n}.{b}"] = getattr(m, b)
            transposed.add(f"{n}.quant_weight")
    return state, transposed


def load_paddle_tpu_state(model, arrays):
    """Copy ``arrays`` ({name: np.ndarray}, the reference model's
    ``named_parameters()`` names, e.g. ``llama.layers.0.self_attn.q_proj
    .weight``, and for a quantized model its ``quant_weight`` and
    ``weight_scale`` buffers) into ``model`` and return ``model``.

    The reference ``Linear`` stores its weight ``[in, out]``; ``nn.Linear``
    stores ``[out, in]``, so Linear weights are transposed, and so are the
    int8 codes ([K, N] or int4 [ceil(K/2), N] there, a row per output
    channel here; copied as they are, bit for bit). The MoE weights keep
    the reference's layout and are copied as they are: a gate's ``weight``
    [M, E], ``SwiGLUExpertStack``'s ``w_gate``/``w_up`` [E, M, H] and
    ``w_down`` [E, H, M], ``ExpertStack``'s ``w1``, ``b1``, ``w2``,
    ``b2``. Raises KeyError on a
    missing or unknown name and ValueError on a shape mismatch, before any
    tensor is written."""
    params, linear = _state(model)
    missing = sorted(set(params) - set(arrays))
    unknown = sorted(set(arrays) - set(params))
    if missing or unknown:
        raise KeyError(f"load_paddle_tpu_state: missing {missing}, "
                       f"unknown {unknown}")
    staged = {}
    for name, arr in arrays.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy
            a = a.astype(np.float32)
        if name in linear:
            a = np.ascontiguousarray(a.T)
        if tuple(a.shape) != tuple(params[name].shape):
            raise ValueError(
                f"load_paddle_tpu_state: {name} has shape {a.shape} "
                f"(after transpose: {name in linear}), the port's parameter "
                f"{tuple(params[name].shape)}")
        staged[name] = torch.tensor(a)
    with torch.no_grad():
        for name, t in staged.items():
            params[name].copy_(t.to(params[name].dtype))
    return model


def export_paddle_tpu_state(model):
    """The inverse of ``load_paddle_tpu_state``: {name: np.ndarray} in the
    reference's layout (Linear weights and int8 codes transposed back to
    [in, out]), f32 for every floating tensor (bf16 and fp16 values widen
    exactly), the codes int8. An fp16 model's weights go back through
    ``load_paddle_tpu_state`` bit for bit (numpy keeps fp16 as it is)."""
    state, linear = _state(model)
    out = {}
    for name, p in state.items():
        t = p.detach().to("cpu")
        if t.is_floating_point():
            t = t.float()
        a = t.numpy()
        out[name] = np.ascontiguousarray(a.T if name in linear else a)
    return out
