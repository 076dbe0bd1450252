"""``matmul`` (counterpart of ``paddle_tpu/tensor/linalg.py`` :17-29): the
product of the last two dims, either side transposed first, its inputs cast
by the autocast mode (``amp.amp_cast_inputs``)."""
from ..amp.auto_cast import amp_cast_inputs


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = amp_cast_inputs("matmul", [x, y])
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return a @ b
