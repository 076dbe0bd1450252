"""The global device mesh (counterpart of ``paddle_tpu/distributed/mesh.py``).

One named mesh carries every parallelism axis, in the reference's order:

    ("dcn_dp", "dp", "pp", "sharding", "sep", "mp")

The reference's mesh is a ``jax.sharding.Mesh`` that one program drives
(single controller); the port keeps that model in one process: a ``Mesh``
is an array of ``torch.device``s shaped by the axes, and the context-
parallel ring (``ops/ring_attention.py``) runs every rank of its ``sep``
axis from this process. A mesh may name one device more than once: the
CPU tests run a sep-4 ring on ``["cpu"] * 4`` and one H100 on ``["cuda:0"]
* 4``.

This slice builds meshes whose only axis above 1 is ``sep``, over one
device. Any other axis above 1, a multi-slice ``dcn_dp``, and a sep axis
over distinct devices raise NotImplementedError: data, tensor and pipeline
parallelism, sharding and the ring across separate cards (NCCL P2P) wait
for a multi-card slice (ROADMAP.md §1 item 8), as do the reference's GSPMD
helpers (``sharding_for``, ``replicated``, ``data_sharding``,
``inside_manual_pp``).
"""
from contextlib import contextmanager

import numpy as np
import torch

from ..device import resolve

AXES = ("dcn_dp", "dp", "pp", "sharding", "sep", "mp")

_LATER = ("waits for a multi-card slice of the port (ROADMAP.md §1 "
          "item 8)")

_global_mesh = None


class Mesh:
    """Devices laid out on named axes: ``devices`` an object array of
    ``torch.device`` shaped like ``axis_names``; ``shape`` {axis: size}."""

    def __init__(self, devices, axis_names=AXES):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} do not "
                             f"match the axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, name):
        """The devices along axis ``name`` (every other axis at index 0)."""
        index = tuple(slice(None) if a == name else 0
                      for a in self.axis_names)
        return list(self.devices[index].reshape(-1))


def _device(d):
    dev = torch.device(d)
    if dev.type == "cuda":
        resolve(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(dp=1, mp=1, pp=1, sharding=1, sep=1, dcn_dp=None,
               slice_size=None, devices=None):
    """The hybrid mesh in the reference's axis order. ``devices`` (default:
    every CUDA device; without CUDA it raises, and a CPU run passes
    ``devices=["cpu"] * n``) are taken in order, the first ``dp * mp * pp *
    sharding * sep`` of them. Only ``sep`` may exceed 1, over one device
    named ``sep`` times; anything else raises NotImplementedError."""
    wider = {name: size for name, size in (("dp", dp), ("mp", mp),
                                           ("pp", pp), ("sharding", sharding))
             if size > 1}
    if wider:
        raise NotImplementedError(
            f"build_mesh: {wider} — only the sep axis may exceed 1; data, "
            f"tensor and pipeline parallelism and sharding {_LATER}")
    if dcn_dp not in (None, 1) or slice_size is not None:
        raise NotImplementedError(f"build_mesh: multi-slice dcn_dp {_LATER}")
    if sep < 1:
        raise ValueError(f"sep must be >= 1, got {sep}")
    if devices is None:
        resolve("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if len(devices) < sep:
        raise ValueError(f"need {sep} devices, have {len(devices)}")
    devices = devices[:sep]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"build_mesh: a sep ring over distinct devices "
            f"{sorted({str(d) for d in devices})} — the ring across cards "
            f"(NCCL send/recv) {_LATER}; name one device sep times")
    arr = np.empty((1, 1, 1, 1, sep, 1), dtype=object)
    for i, d in enumerate(devices):
        arr[0, 0, 0, 0, i, 0] = d
    return Mesh(arr, AXES)


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def get_mesh():
    """The mesh set by ``set_mesh`` or ``mesh_guard``; with none, a
    one-device mesh over the first CUDA device, kept as the global mesh
    (the reference builds dp over every device; dp waits, see above)."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh()
    return _global_mesh


def has_mesh():
    return _global_mesh is not None


def reset_mesh():
    global _global_mesh
    _global_mesh = None


@contextmanager
def mesh_guard(mesh):
    """Make ``mesh`` the global mesh inside the block, then restore the
    previous one."""
    global _global_mesh
    prev = _global_mesh
    _global_mesh = mesh
    try:
        yield mesh
    finally:
        _global_mesh = prev


def axis_size(name):
    mesh = get_mesh()
    return mesh.shape[name] if name in mesh.axis_names else 1
