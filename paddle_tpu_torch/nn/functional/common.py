"""``linear`` (counterpart of ``paddle_tpu/nn/functional/common.py``
:17-28): ``x @ W (+ b)`` with W [in, out] as the reference lays it out,
its inputs cast by the autocast mode first (``amp.amp_cast_inputs``)."""
from ...amp.auto_cast import amp_cast_inputs


def linear(x, weight, bias=None, name=None):
    if bias is None:
        a, w = amp_cast_inputs("linear", [x, weight])
        return a @ w
    a, w, b = amp_cast_inputs("linear", [x, weight, bias])
    return a @ w + b
