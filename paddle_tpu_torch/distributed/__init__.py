"""Distributed training pieces of the port: activation recompute (slice
2), and the one-process device mesh, ``DistributedTrainStep`` and segment
parallel's input split that context-parallel training runs on (slice 5)."""
from .fleet.meta_parallel.segment_parallel import (  # noqa: F401
    split_inputs_sequence_dim,
)
from .mesh import (  # noqa: F401
    AXES, Mesh, axis_size, build_mesh, get_mesh, has_mesh, mesh_guard,
    reset_mesh, set_mesh,
)
from .train_step import DistributedTrainStep  # noqa: F401
