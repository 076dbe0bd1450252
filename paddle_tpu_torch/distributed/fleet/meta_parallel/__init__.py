"""Meta-parallel pieces of the port (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``): segment parallel's input
split."""
from .segment_parallel import split_inputs_sequence_dim  # noqa: F401
