"""Port parity: the MoE gates, routing, dispatch/combine and layer of
``paddle_tpu_torch.incubate.distributed.models.moe`` against the JAX
reference on the CPU, at small sizes, with inputs and weights drawn by
numpy from seeds and fed to both packages.

Tolerances:
- routing (f32): slots, positions and weights identical to the
  reference's ``top_k_dispatch`` (the dense combine and dispatch tensors
  equal element for element); the aux loss within rtol 1e-6, since XLA
  sums the mean of the probabilities in another order than PyTorch (one
  ulp). In bf16, while every position stays below 256, everything is
  identical, aux included;
- the two faults of the reference that the port does not copy: bf16
  positions past 256 collide in the reference (the port holds one token a
  slot and equals the reference's routing on the same probabilities upcast
  to f32), and ties at the k-th choice go to the lower expert index;
- the plain dispatch and combine against the reference's einsums: the
  dispatched rows equal, the combine within rtol 1e-6, gradients within
  rtol 1e-5, atol 1e-6 (1e-5 for the probabilities' gradient, which at
  top-1 is rounding residue around 0 in both frameworks);
- ``MoELayer`` forward within rtol 1e-5, atol 1e-6, and gradients (to the
  tokens, the gate and every expert weight, against ``jax.vjp``) within
  rtol 1e-4, atol 1e-6 (f32; products summed in another order);
- the CUDA tier's autograd functions (``_Dispatch``, ``_Combine``: the
  inverse maps, the per-slot weights of the backward), run on the CPU over
  the kernels' semantics, against the plain version: the dispatched rows
  and the expert outputs' gradient equal (a copy; one product); the
  combine and the tokens' gradient within rtol 1e-6 (sums of k f32
  products, rounded in another order than the einsum's); the
  probabilities' gradient within rtol 1e-5, atol 1e-5 (the weights'
  gradient is a row dot product summed in another order than the einsum's
  backward, and at top-1 it is rounding residue around 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.ops import moe_dispatch as tmd


def _probs(seed, T, E, scale=1.0, dtype="float32"):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    p = jax.nn.softmax(jnp.asarray(logits * scale), axis=-1).astype(dtype)
    return p, torch.tensor(np.asarray(p.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _dense(r):
    combine, dispatch = r.dense()
    return combine.detach().float().numpy(), dispatch.float().numpy()


ROUTE_CASES = {   # (T, E, k, capacity factor, logit scale)
    "top2": (64, 8, 2, 1.25, 1.0),
    "top2-drops": (200, 8, 2, 0.5, 3.0),
    "top1": (100, 4, 1, 1.25, 1.0),
    "top4": (96, 8, 4, 1.0, 1.0),
    "flat-logits": (240, 8, 2, 1.25, 0.1),
}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routing_matches_reference_f32(case, normalize):
    T, E, k, cf, scale = ROUTE_CASES[case]
    C = jgate._capacity(T, E, k, cf)
    assert tgate._capacity(T, E, k, cf) == C
    jp, tp = _probs(1, T, E, scale)
    jc, jd, jaux = jgate.top_k_dispatch(jp, k, C, normalize=normalize)
    r = tgate.route(tp, k, C, normalize=normalize)
    combine, dispatch = _dense(r)
    np.testing.assert_array_equal(combine, np.asarray(jc))
    np.testing.assert_array_equal(dispatch, np.asarray(jd))
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-6)
    assert r.slot.dtype == torch.int32 and r.slot.shape == (T, k)
    # slot = expert * C + position where kept, -1 where dropped
    kept = r.pos < C
    np.testing.assert_array_equal(
        r.slot.numpy(),
        np.where(kept, r.expert * C + r.pos, -1))


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routing_matches_reference_bf16_below_256(case):
    T, E, k, cf, scale = ROUTE_CASES[case]
    C = jgate._capacity(T, E, k, cf)
    jp, tp = _probs(2, T, E, scale, "bfloat16")
    jc, jd, jaux = jgate.top_k_dispatch(jp, k, C)
    r = tgate.route(tp, k, C)
    assert int(r.pos.max()) < 256
    combine, dispatch = _dense(r)
    np.testing.assert_array_equal(combine, np.asarray(jc.astype(jnp.float32)))
    np.testing.assert_array_equal(dispatch,
                                  np.asarray(jd.astype(jnp.float32)))
    assert r.weight.dtype == torch.bfloat16
    assert float(r.aux) == float(jaux)


def test_top_k_dispatch_returns_the_reference_dense_form():
    jp, tp = _probs(3, 48, 6)
    C = tgate._capacity(48, 6, 2, 1.25)
    got = tgate.top_k_dispatch(tp, 2, C)
    want = jgate.top_k_dispatch(jp, 2, C)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planted_ties_go_to_the_lower_expert(dtype):
    """Ties at the k-th choice (and everywhere): lower index first, as
    ``jax.lax.top_k`` orders them."""
    rng = np.random.RandomState(4)
    levels = np.array([0.1, 0.2, 0.3], np.float32)
    p = levels[rng.randint(0, 3, (64, 8))]
    p[:, 5] = p[:, 2]                     # a tie in every row
    p = p / p.sum(-1, keepdims=True)
    jp = jnp.asarray(p).astype(dtype)
    tp = torch.tensor(np.asarray(jp.astype(jnp.float32))).to(
        getattr(torch, dtype))
    r = tgate.route(tp, 2, 16)
    _, idx = jax.lax.top_k(jp, 2)
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(idx))
    jc, _, _ = jgate.top_k_dispatch(jp, 2, 16)
    np.testing.assert_array_equal(_dense(r)[0],
                                  np.asarray(jc.astype(jnp.float32)))


def test_capacity_drops_overflow():
    """tests/test_moe.py:33-41: every token wants expert 0, only C make it."""
    probs = torch.tensor([[0.99, 0.01]]).repeat(8, 1)
    r = tgate.route(probs, 1, 4)
    assert float(r.dense()[1].sum()) == 4
    assert r.slot[:, 0].tolist() == [0, 1, 2, 3, -1, -1, -1, -1]
    assert float(r.weight[4:].abs().sum()) == 0


def test_priority_order():
    """tests/test_moe.py:43-50: earlier tokens win the slots."""
    probs = torch.tensor([[1.0, 0.0]]).repeat(6, 1)
    _, dispatch = tgate.route(probs, 1, 3).dense()
    assert dispatch.sum(dim=(1, 2)).tolist() == [1, 1, 1, 0, 0, 0]


def test_zero_weight_choice_takes_its_position_but_no_slot():
    """probs [1, 0] at top-2: the second choice is kept (position taken)
    but its weight is 0, so dispatch leaves its slot empty."""
    probs = torch.tensor([[1.0, 0.0]]).repeat(3, 1)
    r = tgate.route(probs, 2, 4)
    assert r.pos[:, 1].tolist() == [0, 1, 2]
    assert (r.slot[:, 1] >= 0).all()
    assert r.occupied_slot[:, 1].tolist() == [-1, -1, -1]
    jc, jd, _ = jgate.top_k_dispatch(jnp.asarray(probs.numpy()), 2, 4)
    combine, dispatch = _dense(r)
    np.testing.assert_array_equal(combine, np.asarray(jc))
    np.testing.assert_array_equal(dispatch, np.asarray(jd))
    assert int(r.dispatch_src.ge(0).sum()) == 3


def test_bf16_positions_collide_in_the_reference_not_in_the_port():
    """T 2048, E 8, top-2, C 640 in bf16: the reference's bf16 cumsum puts
    several tokens in some slots; the port holds at most one and equals
    the reference's routing on the same probabilities upcast to f32."""
    T, E, k = 2048, 8, 2
    C = jgate._capacity(T, E, k, 1.25)
    assert C == 640
    jp, tp = _probs(5, T, E, 1.0, "bfloat16")
    _, jd, _ = jgate.top_k_dispatch(jp, k, C)
    per_slot = np.asarray(jd.astype(jnp.float32)).sum(axis=0)
    assert per_slot.max() > 1, "the reference no longer collides"
    r = tgate.route(tp, k, C)
    _, dispatch = r.dense()
    assert float(dispatch.sum(dim=0).max()) == 1
    kept = r.slot[r.slot >= 0]
    assert kept.unique().numel() == kept.numel()
    jc32, _, _ = jgate.top_k_dispatch(jp.astype(jnp.float32), k, C)
    np.testing.assert_array_equal(
        (_dense(r)[0] > 0), np.asarray(jc32) > 0)
    np.testing.assert_allclose(_dense(r)[0], np.asarray(jc32), rtol=1e-2)


# -- the dispatch and combine --------------------------------------------------

def _layer_inputs(seed, T, M, E, k, cf=1.25, scale=2.0):
    rng = np.random.RandomState(seed)
    tokens = rng.randn(T, M).astype(np.float32)
    jp, tp = _probs(seed + 1, T, E, scale)
    C = tgate._capacity(T, E, k, cf)
    expert_out = rng.randn(E, C, M).astype(np.float32)
    dout = rng.randn(T, M).astype(np.float32)
    return tokens, jp, tp, C, expert_out, dout


@pytest.mark.parametrize("k", [1, 2, 4])
def test_plain_dispatch_and_combine_match_reference_einsums(k):
    tokens, jp, tp, C, eo, dout = _layer_inputs(6, 40, 16, 8, k, cf=0.6)

    def ref(tok, probs, x):
        combine, dispatch, _ = jgate.top_k_dispatch(probs, k, C)
        d = jnp.einsum("tec,tm->ecm", dispatch, tok)
        return d, jnp.einsum("tec,ecm->tm", combine, x)

    (jd, jo), vjp = jax.vjp(ref, jnp.asarray(tokens), jp, jnp.asarray(eo))
    dd = np.random.RandomState(7).randn(*jd.shape).astype(np.float32)
    jg = vjp((jnp.asarray(dd), jnp.asarray(dout)))
    t = torch.tensor(tokens, requires_grad=True)
    p = tp.clone().requires_grad_(True)
    x = torch.tensor(eo, requires_grad=True)
    r = tgate.route(p, k, C)
    d = tmd.moe_dispatch(t, r)
    o = tmd.moe_combine(x, r)
    np.testing.assert_array_equal(d.detach().numpy(), np.asarray(jd))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-6, atol=1e-6)
    torch.autograd.backward((d, o), (torch.tensor(dd), torch.tensor(dout)))
    # at top-1 the normalized weight v / (v + 1e-9) has a gradient of
    # ~1e-9 / v: both frameworks leave rounding residue of ~1e-6 there
    for got, want, atol in zip((t.grad, p.grad, x.grad), jg,
                               (1e-6, 1e-5, 1e-6)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=atol)


def _kernel_semantics(monkeypatch):
    """The three kernels' semantics in plain PyTorch on CPU tensors (their
    comments in csrc/moe_dispatch.cu), so the CUDA tier's autograd
    functions run here."""
    def dispatch_rows(x, src, scale=None):
        rows = x[src.clamp(min=0).long()]
        if scale is not None:
            rows = (rows.float() * scale[:, None]).to(x.dtype)
        return torch.where((src >= 0)[:, None], rows, torch.zeros_like(rows))

    def combine_rows(x, slot, w=None):
        out = torch.zeros(slot.shape[0], x.shape[1], dtype=torch.float32)
        for j in range(slot.shape[1]):
            s = slot[:, j]
            wj = torch.ones(s.shape) if w is None else w[:, j]
            term = wj[:, None] * x[s.clamp(min=0).long()].float()
            out = out + torch.where((s >= 0)[:, None], term, 0.0)
        return out.to(x.dtype)

    def combine_dw(dout, x, slot):
        rows = x[slot.clamp(min=0).long()].float()
        dw = (dout.float()[:, None, :] * rows).sum(-1)
        return torch.where(slot >= 0, dw, 0.0)

    monkeypatch.setattr(tmd, "dispatch_rows", dispatch_rows)
    monkeypatch.setattr(tmd, "combine_rows", combine_rows)
    monkeypatch.setattr(tmd, "combine_dw", combine_dw)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_cuda_tier_autograd_matches_plain(monkeypatch, k):
    _kernel_semantics(monkeypatch)
    tokens, _, tp, C, eo, dout = _layer_inputs(8, 40, 16, 8, k, cf=0.6)
    # a zero-weight choice and a fully dropped token among the rows
    tp = tp.clone()
    tp[3] = torch.tensor([1.0] + [0.0] * 7)
    results = []
    for tier in ("plain", "kernel"):
        t = torch.tensor(tokens, requires_grad=True)
        p = tp.clone().requires_grad_(True)
        x = torch.tensor(eo, requires_grad=True)
        r = tgate.route(p, k, C)
        if tier == "plain":
            d, o = tmd._dispatch_math(t, r), tmd._combine_math(x, r)
        else:
            d = tmd._Dispatch.apply(t, r.dispatch_src, r.occupied_slot)
            d = d.view(8, C, 16)
            o = tmd._Combine.apply(x.reshape(8 * C, 16), r.weight, r.slot,
                                   r.dispatch_src)
        dd = torch.tensor(np.random.RandomState(9).randn(8, C, 16),
                          dtype=torch.float32)
        torch.autograd.backward((d, o), (dd, torch.tensor(dout)))
        results.append([v.detach().numpy() for v in
                        (d, o, t.grad, p.grad, x.grad)])
    for name, got, want in zip(("dispatched", "out", "d tokens", "d probs",
                                "d expert_out"), *results[::-1]):
        tol = {"d probs": dict(rtol=1e-5, atol=1e-5),
               "out": dict(rtol=1e-6, atol=1e-7),
               "d tokens": dict(rtol=1e-6, atol=1e-7)}.get(
                   name, dict(rtol=0, atol=0))
        np.testing.assert_allclose(got, want, err_msg=name, **tol)
    assert (results[1][2] != 0).any()


# -- the layer -----------------------------------------------------------------

def _pair_layer(kind, d_model=16, E=4, k=2, recompute_interval=0,
                gate="naive", cf=2.0):
    """The reference's MoELayer and the port's with the same weights."""
    paddle.seed(0)
    kw = dict(recompute_interval=recompute_interval)
    if kind == "list":
        jexp = [paddle.nn.Linear(d_model, d_model) for _ in range(E)]
        texp = [torch.nn.Linear(d_model, d_model) for _ in range(E)]
    elif kind == "swiglu":
        jexp = jmoe.SwiGLUExpertStack(E, d_model, 24, expert_axis=None)
        texp = tmoe.SwiGLUExpertStack(E, d_model, 24, expert_axis=None)
    else:
        jexp = jmoe.ExpertStack(E, d_model, 24, activation=kind,
                                expert_axis=None)
        texp = tmoe.ExpertStack(E, d_model, 24, activation=kind,
                                expert_axis=None)
    if gate == "naive":
        jg = jmoe.NaiveGate(d_model, E, top_k=k, capacity_factor=cf)
        tg = tmoe.NaiveGate(d_model, E, top_k=k, capacity_factor=cf)
    else:
        jg = {"type": gate, "num_expert": E, "top_k": k}
        tg = dict(jg)
    jl = jmoe.MoELayer(d_model, experts=jexp, gate=jg, **kw)
    tl = tmoe.MoELayer(d_model, experts=texp, gate=tg, **kw)
    arrays = {n: np.asarray(p._data) for n, p in jl.named_parameters()}
    if kind == "list":   # paddle Linear [in, out], torch's [out, in]
        arrays = {n: a.T if n.endswith("weight") and "gate" not in n else a
                  for n, a in arrays.items()}
        with torch.no_grad():
            for n, p in tl.named_parameters():
                p.copy_(torch.tensor(arrays[n]))
    else:
        load_paddle_tpu_state(tl, arrays)
    return jl, tl


LAYER_CASES = {
    "gelu": dict(kind="gelu"),
    "relu": dict(kind="relu"),
    "silu": dict(kind="silu"),
    "swiglu": dict(kind="swiglu"),
    "list": dict(kind="list"),
    "recompute": dict(kind="gelu", recompute_interval=1),
    "swiglu-recompute": dict(kind="swiglu", recompute_interval=1),
    "drops": dict(kind="swiglu", cf=0.5),
    "gshard-dict": dict(kind="gelu", gate="gshard"),
    "switch-dict": dict(kind="gelu", gate="switch"),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_forward_and_gradients_match_reference(case):
    jl, tl = _pair_layer(**LAYER_CASES[case])
    jl.eval()
    tl.eval()
    x = np.random.RandomState(1).randn(2, 8, 16).astype(np.float32)
    dy = np.random.RandomState(2).randn(2, 8, 16).astype(np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jl(jx)
    (jout * paddle.to_tensor(dy)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    tout = tl(tx)
    torch.autograd.backward(tout, torch.tensor(dy))
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl.l_aux), float(jl.l_aux.numpy()),
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        g = p.grad.numpy()
        if LAYER_CASES[case]["kind"] == "list" and n.endswith("weight") \
                and "gate" not in n:
            g = g.T
        np.testing.assert_allclose(g, jgrads[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def _noise_both(monkeypatch, noise):
    """Both packages draw ``noise`` ([T, E] f32) for their gate."""
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            noise, dtype))
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape, dtype=jnp.float32, minval=0., maxval=1.:
        jnp.asarray(noise, dtype))
    monkeypatch.setattr(tgate, "_draw_noise",
                        lambda kind, shape, eps, gen, dtype, device:
                        torch.tensor(noise, dtype=dtype, device=device))


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_noisy_gates_match_reference_given_the_same_noise(monkeypatch, gate):
    T, E, M = 16, 4, 8
    rng = np.random.RandomState(3)
    if gate == "gshard":
        noise = rng.gumbel(size=(T, E)).astype(np.float32) * 50
        jg = jmoe.GShardGate(M, E, random_routing=True)
        tg = tmoe.GShardGate(M, E, random_routing=True)
    else:
        noise = rng.uniform(0.9, 1.1, (T, E)).astype(np.float32)
        jg, tg = jmoe.SwitchGate(M, E), tmoe.SwitchGate(M, E)
    load_paddle_tpu_state(tg, {n: np.asarray(p._data)
                               for n, p in jg.named_parameters()})
    _noise_both(monkeypatch, noise)
    jg.train()
    tg.train()
    x = rng.randn(T, M).astype(np.float32)
    jc, _, jaux = jg(paddle.to_tensor(x))
    r = tg(torch.tensor(x))
    np.testing.assert_allclose(_dense(r)[0], np.asarray(jc._data),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(r.aux), float(jaux.numpy()), rtol=1e-6)
    assert float(tg.get_loss()) == float(r.aux) and tg.get_loss() is None
    tg.eval()
    quiet = tg(torch.tensor(x))
    if gate == "gshard":
        assert not torch.equal(quiet.slot, r.slot)


def test_gate_noise_draws_from_the_gate_generator():
    g1, g2 = tmoe.GShardGate(8, 4), tmoe.GShardGate(8, 4)
    g2.load_state_dict(g1.state_dict())
    g1.generator = torch.Generator().manual_seed(5)
    g2.generator = torch.Generator().manual_seed(5)
    x = torch.randn(32, 8)
    a, b = g1(x), g2(x)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(g1(x).weight, a.weight)   # the stream moves on


def test_expert_params_carry_the_reference_flags():
    layer = tmoe.MoELayer(8, experts=tmoe.SwiGLUExpertStack(4, 8, 16),
                          gate={"type": "naive", "num_expert": 4})
    for p in layer.experts.parameters():
        assert p.is_distributed is True
        assert not tmoe.is_expert_param(p)   # no no_sync, as the reference
        p.no_sync = True
        assert tmoe.is_expert_param(p)
    layer.to(torch.float64)
    assert all(p.is_distributed is True for p in layer.experts.parameters())
    assert layer.gate.weight.is_distributed is not True
    assert not tmoe.is_expert_param(layer.gate.weight)
    assert layer.expert_axis == "dp"
    assert isinstance(tmoe.MoE(8, experts=tmoe.ExpertStack(2, 8, 8)).gate,
                      tmoe.GShardGate)


def test_moe_grad_clip_is_the_global_norm_clip():
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    rng = np.random.RandomState(4)
    pg = [(torch.zeros(3), torch.tensor(rng.randn(3), dtype=torch.float32))
          for _ in range(3)]
    clip = tmoe.ClipGradForMOEByGlobalNorm(0.5)
    want = ClipGradByGlobalNorm(0.5)(pg)
    for (_, g), (_, w) in zip(clip(pg), want):
        assert torch.equal(g, w)
    assert clip.is_expert_param_func is tmoe.is_expert_param
    jclip = jmoe.ClipGradForMOEByGlobalNorm(0.5)
    jout = jclip([(paddle.to_tensor(np.zeros(3, np.float32)),
                   paddle.to_tensor(g.numpy())) for _, g in pg])
    for (_, g), (_, j) in zip(clip(pg), jout):
        np.testing.assert_allclose(g.numpy(), j.numpy(), rtol=1e-6)


def test_convert_carries_gate_and_experts_both_ways():
    jl, tl = _pair_layer("swiglu")
    got = export_paddle_tpu_state(tl)
    for n, p in jl.named_parameters():
        np.testing.assert_array_equal(got[n], np.asarray(p._data))
    assert got["gate.weight"].shape == (16, 4)
    assert got["experts.w_down"].shape == (4, 24, 16)
    jl, tl = _pair_layer("gelu")
    assert sorted(export_paddle_tpu_state(tl)) == sorted(
        n for n, _ in jl.named_parameters())


def test_xavier_uniform_follows_the_reference_fan_rule():
    w = torch.empty(8, 64, 32)
    tgate.xavier_uniform_(w, torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (64 * 32 + 8 * 32))
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    assert tgate._fans((8, 64, 32)) == jax_fans((8, 64, 32))


def jax_fans(shape):
    from paddle_tpu.nn import initializer

    return initializer._fans(shape)
