"""MoE layer (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

The reference's layer is three einsums over dense dispatch/combine tensors
(:149, :163) around the expert bank. The port routes compactly: the gate
gives a ``Routing``, ``ops.moe_dispatch.moe_dispatch`` moves each kept
token into its expert slot (kernel D on the card), the expert bank runs
on [E, C, M], and ``moe_combine`` sums each token's weighted slots back
(kernel E). On the CPU both are the reference's einsums.

Every expert is local: ``expert_axis`` is accepted and recorded, as the
reference does, and the expert parameters carry ``is_distributed`` as the
reference's do; a mesh whose dp axis exceeds 1 raises in
``distributed.mesh``, so no expert is sharded.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .....distributed.fleet.recompute import recompute
from .....ops.moe_dispatch import moe_combine, moe_dispatch
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, xavier_uniform_


class _StackedExperts(nn.Module):
    """Marker base for stacked-weight expert banks ([E, ...] parameters,
    one batched product over all experts). ``_WEIGHTS`` are drawn from
    XavierUniform, ``_BIASES`` start at zero."""

    _WEIGHTS = ()
    _BIASES = ()

    def _param(self, *shape, device=None, dtype=None):
        return nn.Parameter(torch.zeros(*shape, device=device, dtype=dtype))

    def reset_parameters(self):
        for name in self._WEIGHTS:
            xavier_uniform_(getattr(self, name))
        with torch.no_grad():
            for name in self._BIASES:
                getattr(self, name).zero_()

    def _mark(self):
        """The reference's flags on the expert parameters (set again after
        a device or dtype move, or a copy, makes new Parameter objects)."""
        if self.expert_axis:
            for name in self._WEIGHTS + self._BIASES:
                getattr(self, name).is_distributed = True

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        self._mark()
        return out

    def __setstate__(self, state):
        # a copied Parameter does not carry the flags
        super().__setstate__(state)
        self._mark()

    def _init(self):
        self._mark()
        if next(self.parameters()).device.type != "meta":
            self.reset_parameters()


class ExpertStack(_StackedExperts):
    """E feed-forward experts in stacked weights (reference :34): w1 [E, M,
    H], b1 [E, 1, H], w2 [E, H, M], b2 [E, 1, M]; act(x @ w1 + b1) @ w2 +
    b2 with act gelu (tanh form, as ``jax.nn.gelu``), relu or silu."""

    _WEIGHTS = ("w1", "w2")
    _BIASES = ("b1", "b2")
    _ACTS = {"gelu": lambda h: F.gelu(h, approximate="tanh"),
             "relu": F.relu, "silu": F.silu}

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu",
                 expert_axis="dp", device=None, dtype=None):
        super().__init__()
        if activation not in self._ACTS:
            raise ValueError(f"activation must be one of "
                             f"{sorted(self._ACTS)}, got {activation!r}")
        self.num_expert, self.d_model, self.d_hidden = (num_expert, d_model,
                                                        d_hidden)
        self.activation = activation
        self.expert_axis = expert_axis
        kw = dict(device=device, dtype=dtype)
        self.w1 = self._param(num_expert, d_model, d_hidden, **kw)
        self.b1 = self._param(num_expert, 1, d_hidden, **kw)
        self.w2 = self._param(num_expert, d_hidden, d_model, **kw)
        self.b2 = self._param(num_expert, 1, d_model, **kw)
        self._init()

    def forward(self, dispatched):
        """dispatched [E, C, M] -> [E, C, M]."""
        h = torch.bmm(dispatched, self.w1) + self.b1
        return torch.bmm(self._ACTS[self.activation](h), self.w2) + self.b2


class SwiGLUExpertStack(_StackedExperts):
    """E gated (LLaMA-style) experts (reference :71): silu(x @ w_gate) *
    (x @ w_up) @ w_down, w_gate and w_up [E, M, H], w_down [E, H, M] (the
    reference's layout)."""

    _WEIGHTS = ("w_gate", "w_up", "w_down")

    def __init__(self, num_expert, d_model, d_hidden, expert_axis="dp",
                 device=None, dtype=None):
        super().__init__()
        self.num_expert, self.d_model, self.d_hidden = (num_expert, d_model,
                                                        d_hidden)
        self.expert_axis = expert_axis
        kw = dict(device=device, dtype=dtype)
        self.w_gate = self._param(num_expert, d_model, d_hidden, **kw)
        self.w_up = self._param(num_expert, d_model, d_hidden, **kw)
        self.w_down = self._param(num_expert, d_hidden, d_model, **kw)
        self._init()

    def forward(self, dispatched):
        """dispatched [E, C, M] -> [E, C, M]."""
        h = F.silu(torch.bmm(dispatched, self.w_gate)) * torch.bmm(
            dispatched, self.w_up)
        return torch.bmm(h, self.w_down)


_GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


class MoELayer(nn.Module):
    """The reference's signature (:105): ``experts`` is a stacked bank
    (``ExpertStack``, ``SwiGLUExpertStack``) or a list of per-expert
    modules (run one after the other on their [C, M] slices); ``gate`` a
    gate, a config dict ({"type": "naive" | "gshard" | "switch",
    "num_expert", "top_k"}) or None (a ``GShardGate``).
    ``recompute_interval`` > 0 runs the experts under ``recompute``.
    ``l_aux`` is the last forward's load-balancing loss. ``device`` and
    ``dtype`` reach a gate built here."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, random_routing=False,
                 expert_axis="dp", device=None, dtype=None, **kwargs):
        super().__init__()
        self.d_model = d_model
        stacked = isinstance(experts, _StackedExperts)
        default_n = (experts.num_expert if stacked
                     else len(experts) if experts is not None else 1)
        kw = dict(device=device, dtype=dtype)
        if isinstance(gate, dict):
            gate_type = gate.get("type", "gshard")
            num_expert = gate.get("num_expert", default_n)
            top_k = gate.get("top_k", 2)
            cls = _GATES[gate_type]
            if gate_type == "switch":
                gate = cls(d_model, num_expert, **kw)
            elif gate_type == "gshard":
                gate = cls(d_model, num_expert, top_k=top_k,
                           random_routing=random_routing, **kw)
            else:
                gate = cls(d_model, num_expert, top_k=top_k, **kw)
        if gate is None:
            gate = GShardGate(d_model, default_n, **kw)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate, a config dict or "
                            f"None, got {type(gate).__name__}")
        self.gate = gate
        if isinstance(experts, (list, tuple)):
            experts = nn.ModuleList(experts)
        self.experts = experts
        self.num_expert = gate.tot_expert
        self.recompute_interval = recompute_interval
        self.expert_axis = expert_axis
        self.l_aux = None

    def __getstate__(self):
        # the last forward's aux loss holds its graph: a copy starts without
        state = self.__dict__.copy()
        state["l_aux"] = None
        return state

    def forward(self, x):
        """x [..., M] -> [..., M]."""
        M = x.shape[-1]
        tokens = x.reshape(-1, M)
        routing = self.gate(tokens)
        self.l_aux = routing.aux
        dispatched = moe_dispatch(tokens, routing)       # [E, C, M]
        remat = self.recompute_interval > 0
        if isinstance(self.experts, _StackedExperts):
            expert_out = (recompute(self.experts, dispatched) if remat
                          else self.experts(dispatched))
        else:
            expert_out = torch.stack([
                recompute(e, dispatched[i]) if remat else e(dispatched[i])
                for i, e in enumerate(self.experts)])
        return moe_combine(expert_out, routing).reshape(x.shape)


class MoE(MoELayer):
    """Back-compat alias (the reference exposes both names)."""
