"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

The eager API (``scale``, ``unscale_``, ``step``, ``update``, ``minimize``)
for a hand-written loop, and the state machine ``init_state`` /
``update_state`` (reference :97-115) that ``TrainStep`` runs on the device:
the scale and the good and bad step counts are torch scalars there, and
``update_state`` moves them with ``torch.where`` as the reference's
``jnp.where`` does, so no host read decides the next scale.
"""
import numpy as np
import torch

from ..device import resolve


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled_opts = set()  # optimizers already unscaled this step

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every ``.grad`` of ``optimizer`` by 1 / scale in f32
        and cast it back, noting whether any was NaN or Inf (one host read
        for all of them)."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        self._unscaled_opts.add(id(optimizer))
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameter_list or []:
            if p.grad is not None:
                g = p.grad.float() * inv
                finite.append(torch.isfinite(g).all())
                p.grad = g.to(p.grad.dtype)
        self._found_inf = bool(finite) and not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        self._unscaled_opts.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    # -- the state machine of the compiled step, on the device --------------
    def init_state(self, device="cuda"):
        """The scaler's carry on ``device`` (default the card; raises
        without CUDA unless given ``device="cpu"``)."""
        device = resolve(device)
        return {"scale": torch.tensor(self._scale, dtype=torch.float32,
                                      device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "bad": torch.zeros((), dtype=torch.int32, device=device)}

    def update_state(self, state, finite):
        """The next state after a step whose gradients were ``finite`` (a
        bool scalar tensor); f32 and int32 as the reference's."""
        zero = torch.zeros_like(state["good"])
        good = torch.where(finite, state["good"] + 1, zero)
        bad = torch.where(finite, zero, state["bad"] + 1)
        incr = good >= self._incr_every_n_steps
        decr = bad >= self._decr_every_n
        scale = torch.where(incr, state["scale"] * self._incr_ratio,
                            state["scale"])
        scale = torch.where(decr, torch.clamp_min(
            scale * self._decr_ratio, 1.0), scale)
        return {"scale": scale, "good": torch.where(incr, zero, good),
                "bad": torch.where(decr, zero, bad)}

    def state_dict(self):
        return {
            "scale": np.float32(self._scale),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, sd):
        self._scale = float(sd.get("scale", self._scale))
        self._good_steps = int(sd.get("good_steps", 0))
        self._bad_steps = int(sd.get("bad_steps", 0))


AmpScaler = GradScaler
