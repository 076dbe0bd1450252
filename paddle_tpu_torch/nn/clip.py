"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clip maps ``[(param, grad), ...]`` to the same list with clipped
gradients, as the reference's do. ``ClipGradByGlobalNorm`` takes its sums
from ``ops.grad_norm.grad_sumsq``: one launch of the gradient-norm kernel
over every CUDA gradient (the plain version on the CPU), whose factor stays
on the device; ``TrainStep`` hands that factor to the optimizer's update
kernel instead of scaling the gradients here. The other clips are plain
PyTorch, as the reference leaves them to XLA.
"""
import torch

from ..ops.grad_norm import grad_sumsq


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: ``g * min(1, clip / max(||g||, 1e-12))``,
    in the gradient's dtype (reference :32-48)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                n = (g * g).sum().sqrt()
                g = g * torch.clamp(
                    self.clip_norm / torch.clamp(n, min=1e-12), max=1.0)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients together: ``gnorm = sqrt(sum_t sum(g_t.f32^2))`` (the
    tensors' sums added in order), ``factor = min(1, clip / max(gnorm,
    1e-12))``, ``g = (g.f32 * factor).astype(g.dtype)`` (reference
    :51-76). ``auto_skip_clip`` (skip the clip while the norm is under
    ``clip_norm``) takes the reference's signature and needs no code: the
    factor is then exactly 1 and leaves every gradient as it was."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def stats(self, grads, scale=None, groups=None, n_groups=0):
        """``grad_sumsq`` of the gradients that are not None, with this
        clip's factor (``.factor``) and ``grads / scale`` first when a
        scale is given."""
        return grad_sumsq([g for g in grads if g is not None], scale=scale,
                          clip_norm=self.clip_norm, groups=groups,
                          n_groups=n_groups)

    def global_norm(self, grads):
        if all(g is None for g in grads):
            return None
        return self.stats(grads).norm

    def _clip(self, params_grads):
        if all(g is None for _, g in params_grads):
            return params_grads
        factor = self.stats([g for _, g in params_grads]).factor
        return [(p, g if g is None else (g.float() * factor).to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` in place by ``min(1, max_norm / (total +
    1e-6))``, total the ``norm_type`` norm over all of them (reference
    :79-90); returns the total."""
    ps = [p for p in (parameters if isinstance(parameters, (list, tuple))
                      else [parameters]) if p.grad is not None]
    if not ps:
        return torch.zeros(())
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.stack([p.grad.abs().max() for p in ps]).max()
        else:
            total = torch.stack([(p.grad.abs() ** norm_type).sum()
                                 for p in ps]).sum() ** (1.0 / norm_type)
        factor = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for p in ps:
            p.grad = p.grad * factor
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every ``.grad`` to [-clip_value, clip_value] (reference
    :93-97)."""
    ps = parameters if isinstance(parameters, (list, tuple)) else [parameters]
    for p in ps:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad.detach(), -clip_value, clip_value)
