"""Carry a reference model's weights into the port."""
import numpy as np
import torch
from torch import nn


def load_paddle_tpu_state(model, arrays):
    """Copy ``arrays`` ({name: np.ndarray}, the reference model's
    ``named_parameters()`` names, e.g. ``llama.layers.0.self_attn.q_proj
    .weight``) into ``model``'s parameters and return ``model``.

    The reference ``Linear`` stores its weight ``[in, out]``; ``nn.Linear``
    stores ``[out, in]``, so Linear weights are transposed. Raises KeyError
    on a missing or unknown name and ValueError on a shape mismatch, before
    any parameter is written."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unknown = sorted(set(arrays) - set(params))
    if missing or unknown:
        raise KeyError(f"load_paddle_tpu_state: missing {missing}, "
                       f"unknown {unknown}")
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    staged = {}
    for name, arr in arrays.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy
            a = a.astype(np.float32)
        if name in linear:
            a = a.T
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
    reference's layout (Linear weights transposed back to [in, out]), f32
    for every floating parameter (bf16 values widen exactly)."""
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().to("cpu")
        if t.is_floating_point():
            t = t.float()
        a = t.numpy()
        out[name] = np.ascontiguousarray(a.T if name in linear else a)
    return out
