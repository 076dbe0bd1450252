"""Segment (sep) parallel's input split (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/segment_parallel.py``).

Only ``split_inputs_sequence_dim`` is ported; ``SegmentParallel``, the
model wrapper ``fleet.distributed_model`` picks when sep_degree > 1, waits
for fleet (ROADMAP.md §1 item 8).
"""
import torch

from ...mesh import axis_size


def split_inputs_sequence_dim(inputs, rank=None, degree=None, axis=1):
    """Rank ``rank``'s slice of each tensor's sequence dim ``axis`` cut into
    ``degree`` (default: the mesh's sep axis size) equal parts; a tensor or
    a list or tuple of them, anything else returned as it is. Single
    controller, as the reference: without a ``rank`` (or with a degree of
    1) the inputs stay whole, and the context-parallel model cuts its
    attention into shards itself."""
    degree = degree if degree is not None else axis_size("sep")
    if degree <= 1 or rank is None:
        return inputs

    def split(x):
        if not isinstance(x, torch.Tensor):
            return x
        size = x.shape[axis] // degree
        return x.narrow(axis, rank * size, size)

    if isinstance(inputs, (list, tuple)):
        return type(inputs)(split(x) for x in inputs)
    return split(inputs)
