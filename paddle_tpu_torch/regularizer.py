"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

An optimizer given one as ``weight_decay`` adds it to each gradient before
its rule, on the parameter it updates (the f32 master weight where there is
one): ``L2Decay`` adds ``coeff * p``, ``L1Decay`` ``coeff * sign(p)``, each a
product in that parameter's dtype with ``coeff`` rounded to that dtype
first, as the reference's Python scalar is (reference
``optimizer/optimizer.py:88-94``; PyTorch would multiply a bf16 tensor by
the unrounded scalar). ``optimizer.L1Decay`` and
``optimizer.L2Decay`` are these classes.
"""
import torch


def _in(coeff, param):
    """``coeff`` rounded to ``param``'s dtype."""
    return float(torch.tensor(coeff, dtype=param.dtype))


class WeightDecayRegularizer:
    def __call__(self, param):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return _in(self.coeff, param) * torch.sign(param)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return _in(self.coeff, param) * param

    def __repr__(self):
        return f"L2Decay({self.coeff})"
