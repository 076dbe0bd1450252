"""MoE gates (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

A gate maps tokens [T, M] to a compact top-k ``Routing`` with a static
expert capacity C (``ops.moe_dispatch``): per token and choice the expert,
the position in its queue, the slot ``e * C + pos`` (-1 when dropped) and
the kept weight, plus the load-balancing loss. ``top_k_dispatch`` keeps
the reference's signature and returns its dense ``(combine, dispatch,
aux)`` [T, E, C] built from the same routing.

Two traits of the reference are not kept, since they are faults:
- the reference counts positions with a cumsum in the probabilities' dtype
  (gate.py:40-48); bf16 holds integers exactly only to 256, so past that
  several tokens land in one slot. Positions here are int32: in f32, and
  in bf16 while every position is below 256, the routing equals the
  reference's;
- ``jax.lax.top_k`` puts the lower index first among equal values, and
  ``torch.topk`` promises no order: the top k here come from a stable
  descending sort, lower index first on both devices.
Everything else follows the reference's arithmetic: the normalization
``vals / (sum + 1e-9)`` in the probabilities' dtype, positions k-major
(every first choice queues before any second choice), ``keep = pos < C``,
and ``aux = E * sum(mean(probs) * mean(first-choice one-hot))``.

The noisy gates (GShard's Gumbel perturbation, Switch's multiplicative
uniform noise; gate.py:85-114) draw from the gate's ``torch.Generator``
(``generator``: set it, or one seeded with 0 is made on the input's device
at the first draw) through ``_draw_noise``.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from .....device import constant
from .....ops.moe_dispatch import Routing


def _capacity(num_tokens, num_experts, top_k, capacity_factor):
    cap = int(capacity_factor * top_k * num_tokens / num_experts)
    return max(cap, 4)


def _fans(shape):
    """The reference initializer's fan rule (paddle_tpu/nn/initializer):
    a 3-d [E, M, H] weight has fan_in M * H and fan_out E * H."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def xavier_uniform_(p, generator=None):
    """Fill ``p`` with the reference's XavierUniform: U(-l, l), l =
    sqrt(6 / (fan_in + fan_out)), drawn in f32 and cast to p's dtype."""
    fi, fo = _fans(tuple(p.shape))
    limit = math.sqrt(6.0 / (fi + fo))
    with torch.no_grad():
        u = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        p.copy_(u.uniform_(-limit, limit, generator=generator))
    return p


def route(probs, top_k, capacity, normalize=True):
    """GShard-style top-k routing of ``probs`` [T, E] with positional
    capacity assignment (reference ``top_k_dispatch``, gate.py:29) as a
    ``Routing``; differentiable in ``probs`` through the weights and the
    aux loss."""
    T, E = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert = vals[:, :top_k], idx[:, :top_k]
    if normalize:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True)
                                 + constant(1e-9, gate_vals))
    # k-major queue: all first choices before any second choice; the
    # count runs along each expert's contiguous row of k T entries (a
    # scan down the E columns of [k T, E] leaves the card nearly idle)
    kmaj = expert.t().reshape(-1)
    onehot = F.one_hot(kmaj, E).t().contiguous().to(torch.int32)
    pos = (torch.cumsum(onehot, 1, dtype=torch.int32) - onehot).gather(
        0, kmaj[None]).view(top_k, T).t()
    kept = pos < capacity
    slot = torch.where(kept, expert.to(torch.int32) * capacity + pos,
                       -1).to(torch.int32).contiguous()
    weight = torch.where(kept, gate_vals, torch.zeros((), dtype=probs.dtype,
                                                      device=probs.device))
    me = probs.mean(dim=0)
    ce = F.one_hot(expert[:, 0], E).to(probs.dtype).mean(dim=0)
    aux = (me * ce).sum() * E
    return Routing(expert, pos.contiguous(), slot, weight, aux, E, capacity)


def top_k_dispatch(probs, top_k, capacity, normalize=True):
    """The reference's dense form: (combine [T, E, C], dispatch [T, E, C],
    aux) from ``route``."""
    r = route(probs, top_k, capacity, normalize)
    combine, dispatch = r.dense()
    return combine, dispatch, r.aux


def _draw_noise(kind, shape, eps, generator, dtype, device):
    """The noisy gates' draws: "gumbel" (standard Gumbel, added as eps * g)
    or "mult_uniform" (U[1 - eps, 1 + eps], multiplied), in ``dtype``."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "gumbel":
        tiny = torch.finfo(torch.float32).tiny
        u.uniform_(tiny, 1.0, generator=generator)
        return (-torch.log(-torch.log(u))).to(dtype)
    return u.uniform_(1.0 - eps, 1.0 + eps, generator=generator).to(dtype)


class BaseGate(nn.Module):
    """The learned top-k gate: weight [d_model, E] (the reference's layout,
    XavierUniform), ``forward(x [T, M]) -> Routing``; the aux loss of the
    last routing is kept for ``get_loss``."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity_factor=1.25, device=None, dtype=None):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.generator = None
        self.weight = nn.Parameter(torch.empty(
            d_model, self.tot_expert, device=device, dtype=dtype))
        if self.weight.device.type != "meta":
            xavier_uniform_(self.weight)
        self._loss = None

    def __getstate__(self):
        # the last routing's aux loss holds its graph: a copy starts without
        state = self.__dict__.copy()
        state["_loss"] = None
        return state

    def get_loss(self, clear=True):
        loss = self._loss
        if clear:
            self._loss = None
        return loss

    def set_loss(self, loss):
        self._loss = loss

    def _noise(self, kind, shape, eps, like):
        if self.generator is None or self.generator.device != like.device:
            self.generator = torch.Generator(like.device).manual_seed(0)
        return _draw_noise(kind, shape, eps, self.generator, like.dtype,
                           like.device)

    def _route(self, x, noise="none", noise_eps=0.0):
        """x [T, M] -> Routing (reference ``BaseGate._route`` :85):
        logits x @ weight, optionally perturbed ("mult_uniform": times
        U[1 - eps, 1 + eps]; "gumbel": plus eps * Gumbel), softmax in f32
        cast back to x's dtype, then ``route`` at capacity
        ``_capacity(T, E, k, capacity_factor)``."""
        cap = _capacity(x.shape[0], self.tot_expert, self.top_k,
                        self.capacity_factor)
        logits = x @ self.weight
        if noise == "mult_uniform":
            logits = logits * self._noise(noise, logits.shape, noise_eps,
                                          logits)
        elif noise == "gumbel":
            logits = logits + noise_eps * self._noise(noise, logits.shape,
                                                      noise_eps, logits)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        r = route(probs, self.top_k, cap)
        self.set_loss(r.aux)
        return r

    def forward(self, x):
        return self._route(x)


class NaiveGate(BaseGate):
    """Plain learned top-k gate, no noise (reference :120)."""


class GShardGate(BaseGate):
    """Top-2 gate with the load-balance aux loss (reference :124);
    ``random_routing`` perturbs the logits with Gumbel noise (eps 0.01)
    while training."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 **kw):
        cf = capacity[0] if isinstance(capacity, (tuple, list)) else capacity
        super().__init__(d_model, num_expert, world_size, top_k=top_k,
                         capacity_factor=cf, **kw)
        self.random_routing = random_routing

    def forward(self, x):
        if self.random_routing and self.training:
            return self._route(x, noise="gumbel", noise_eps=0.01)
        return self._route(x)


class SwitchGate(BaseGate):
    """Top-1 switch gate (reference :143): logits times U[1 - eps, 1 +
    eps] while training."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, **kw):
        cf = capacity[0] if isinstance(capacity, (tuple, list)) else capacity
        super().__init__(d_model, num_expert, world_size, top_k=1,
                         capacity_factor=cf, **kw)
        self.switch_eps = switch_eps

    def forward(self, x):
        if self.training and self.switch_eps:
            return self._route(x, noise="mult_uniform",
                               noise_eps=self.switch_eps)
        return self._route(x)
