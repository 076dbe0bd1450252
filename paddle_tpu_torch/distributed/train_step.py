"""DistributedTrainStep (counterpart of
``paddle_tpu/distributed/train_step.py``).

The reference compiles the step under GSPMD shardings: weights, optimizer
slots and the batch laid out on the mesh, with the sequence dim of [B, S]
inputs sharded on ``sep`` when the model is context-parallel
(``_batch_spec`` :112). The port runs ``TrainStep``'s eager step inside
``mesh_guard(mesh)``: the context-parallel model cuts its attention into
the sep ranks' shards itself (``LlamaAttention._ring_attention``), and
everything else is whole on the mesh's one device, the AMP scaler and the
metrics bus as ``TrainStep`` runs them. Sharding stages, other batch axes,
snapshots and ``full_state_dict`` raise NotImplementedError until a
multi-card slice (ROADMAP.md §1 item 8).
"""
from ..jit_api import TrainStep
from .mesh import _LATER, get_mesh, mesh_guard

_BATCH_AXES = ("dcn_dp", "dp", "sharding")


class DistributedTrainStep(TrainStep):
    """``DistributedTrainStep(model, loss_fn, optimizer, mesh=...)(*batch)``:
    one ``TrainStep`` step under ``mesh`` (default: ``get_mesh()``) on the
    mesh's device. The mesh's only axis above 1 may be ``sep``; when the
    model's config sets ``context_parallel``, every [B, S, ...] batch array
    must have S divisible by it."""

    def __init__(self, model, loss_fn, optimizer, n_labels=1, scaler=None,
                 mesh=None, sharding_stage=1, batch_axes=_BATCH_AXES,
                 metrics_bus=None, accumulate_steps=1, nonfinite_guard=None):
        self.mesh = mesh if mesh is not None else get_mesh()
        wider = {a: n for a, n in self.mesh.shape.items()
                 if a != "sep" and n > 1}
        if wider:
            raise NotImplementedError(
                f"DistributedTrainStep: mesh axes {wider} — only sep may "
                f"exceed 1; {_LATER}")
        refused = {
            "sharding_stage > 1": sharding_stage > 1,
            "batch_axes other than the reference's default":
                tuple(batch_axes) != _BATCH_AXES,
        }
        for what, is_set in refused.items():
            if is_set:
                raise NotImplementedError(
                    f"DistributedTrainStep: {what} {_LATER}")
        self.sharding_stage = sharding_stage
        self.batch_axes = tuple(batch_axes)
        devices = {d for d in self.mesh.devices.flat}
        super().__init__(model, loss_fn, optimizer, n_labels=n_labels,
                         scaler=scaler, metrics_bus=metrics_bus,
                         accumulate_steps=accumulate_steps,
                         nonfinite_guard=nonfinite_guard,
                         device=next(iter(devices)))

    def _sep(self):
        """The sep ranks the batch's sequence dim is cut into (1 when the
        model is not context-parallel)."""
        cp = getattr(getattr(self.model, "config", None), "context_parallel",
                     False)
        return self.mesh.shape.get("sep", 1) if cp else 1

    def _check_sequence(self, batch, dim):
        """Every batch array of rank > ``dim`` has its sequence dim
        ``dim`` divisible by the sep ranks."""
        sep = self._sep()
        for b in batch:
            shape = getattr(b, "shape", ())
            if len(shape) > dim and shape[dim] % sep:
                raise ValueError(
                    f"context_parallel: sequence length {shape[dim]} is not "
                    f"divisible by the sep axis size {sep} — pad the "
                    "sequence or change the mesh")

    def __call__(self, *batch):
        self._check_sequence(batch, 1)
        with mesh_guard(self.mesh):
            return super().__call__(*batch)

    def run_steps(self, *batch, n, stacked=False):
        """``TrainStep.run_steps`` under the mesh (reference :364): the n
        steps go through the sep ring as ``__call__``'s do. A stacked
        batch carries its sequence dim one to the right."""
        self._check_sequence(batch, 2 if stacked else 1)
        with mesh_guard(self.mesh):
            return super().run_steps(*batch, n=n, stacked=stacked)

    def full_state_dict(self):
        raise NotImplementedError(
            f"DistributedTrainStep.full_state_dict: checkpoint tiers {_LATER}")

    def load_full_state_dict(self, sd, step=None):
        raise NotImplementedError(
            "DistributedTrainStep.load_full_state_dict: checkpoint tiers "
            f"{_LATER}")

    def attach_snapshot_ring(self, ring, every=None, replicator=None):
        raise NotImplementedError(
            f"DistributedTrainStep.attach_snapshot_ring: snapshots {_LATER}")

