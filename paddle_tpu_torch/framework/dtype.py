"""Paddle's dtype names over torch dtypes (the port's counterpart of
``paddle_tpu/framework/dtype.py``; reference: paddle/phi/common/
data_type.h and python/paddle/framework/dtype.py), and the default
floating dtype."""
import torch

bool = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME2DTYPE = {
    "bool": bool, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """A dtype spec (a name, a torch dtype, or anything numpy names) as a
    torch dtype; None stays None. Raises ValueError on an unknown name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _NAME2DTYPE:
            raise ValueError(f"unknown dtype {dtype!r}")
        return _NAME2DTYPE[dtype]
    import numpy as np

    return _NAME2DTYPE[np.dtype(dtype).name]


def dtype_name(dtype):
    """The paddle name of ``dtype`` ('float16', 'bfloat16', ...)."""
    return str(convert_dtype(dtype)).removeprefix("torch.")


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return _default_dtype


def is_floating_point_dtype(dtype):
    return convert_dtype(dtype).is_floating_point


def iinfo(dtype):
    """torch.iinfo of ``dtype`` (bits, min, max), as paddle.iinfo."""
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    """torch.finfo of ``dtype`` (bits, eps, min, max, tiny, resolution),
    as paddle.finfo."""
    return torch.finfo(convert_dtype(dtype))
