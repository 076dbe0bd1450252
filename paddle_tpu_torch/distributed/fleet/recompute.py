"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute.py``).

The reference wraps the segment in ``jax.checkpoint``; the port uses
``torch.utils.checkpoint`` (non-reentrant): the segment's activations are
dropped after the forward and recomputed in the backward. Policies:

- "full" (or None) and "nothing": recompute everything;
- "dots": keep the outputs of the matrix products (``aten.mm``,
  ``aten.addmm``, ``aten.bmm``) and recompute the rest, the counterpart of
  ``dots_with_no_batch_dims_saveable``.

Kernels launched inside the segment (the flash-attention forward, K1 or,
for packed rows, K3) run again in the backward under every policy: only
aten products are kept. Keyword arguments reach the segment as they are
(a decoder layer's ``segment_ids``, as the reference's
``models/llama.py`` :522-525 passes them).
"""
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _context_fn(policy):
    if policy is None or policy in ("full", "nothing"):
        return None
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    raise ValueError(f"unknown recompute policy {policy!r} "
                     "(full|dots|nothing)")


def recompute(function, *args, policy=None, preserve_rng_state=True,
              **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs (and,
    under "dots", its product outputs) for the backward."""
    context_fn = _context_fn(policy)
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)
