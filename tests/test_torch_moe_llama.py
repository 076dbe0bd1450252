"""Port parity: the mixture-of-experts LLaMA (``LlamaConfig(num_experts >
1)``) of ``paddle_tpu_torch`` against the JAX reference on the CPU, at
``llama_tiny`` sizes (4 experts, top-2 unless stated, 2 layers), with the
reference's weights carried over by ``load_paddle_tpu_state`` and inputs
drawn by numpy from seeds. Each test mirrors one of
``tests/test_moe_llama.py`` or ``tests/test_feature_composition.py``.

Tolerances (f32):
- the labeled loss (aux included, and with ``moe_aux_loss_weight`` 0;
  the switch gate given the same training noise in both packages)
  within rtol 1e-5, every parameter gradient within rtol 1e-4, atol 1e-6,
  the aux loss within rtol 1e-6, and every layer's routing identical: the
  same slots for the same tokens (the dense dispatch tensors equal), the
  weights within rtol 1e-6;
- 3 ``TrainStep``s with ``make_loss_fn`` against the reference's: losses
  within rtol 1e-5, parameters within atol 3e-5 (as
  tests/test_torch_training.py states it: Adam's step is about lr where a
  gradient sits near zero);
- greedy ``generate`` and the engine's greedy serve: tokens identical;
- under context parallelism (the sep-4 ring over the CPU four times) the
  first ``DistributedTrainStep``'s loss equals the no-mesh labeled
  forward's within rtol 2e-5, atol 2e-6 (the reference's own tolerance,
  tests/test_feature_composition.py:132-141).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.distributed import DistributedTrainStep, build_mesh
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.optimizer import AdamW

MOE = dict(num_hidden_layers=2, num_experts=4, moe_top_k=2)


def _pair(seed=41, **kw):
    cfg = dict(MOE, **kw)
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(**cfg))
    tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _batch(seed, B=8, S=12, vocab=128):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)


def test_config_builds_with_experts():
    cfg = LlamaConfig(num_experts=8, num_hidden_layers=1, hidden_size=64,
                      intermediate_size=128, num_attention_heads=4,
                      vocab_size=128)
    model = LlamaForCausalLM(cfg, device="cpu")
    mlp = model.llama.layers[0].mlp
    assert mlp.num_expert == 8 and mlp.gate.top_k == 2
    assert type(mlp.gate).__name__ == "GShardGate"
    assert tuple(mlp.experts.w_gate.shape) == (8, 64, 128)
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        LlamaConfig(sequence_parallel=True)
    assert LlamaForCausalLM.flops_per_token(cfg, 16) == \
        JaxLlama.flops_per_token(jax_tiny(**dict(
            num_experts=8, num_hidden_layers=1)), 16)


def _record_port_routing(tm):
    seen = []
    for layer in tm.llama.layers:
        layer.mlp.gate.register_forward_hook(
            lambda m, a, out: seen.append(out))
    return seen


def _record_reference_gate_inputs(monkeypatch):
    seen = []
    orig = jgate.BaseGate._route

    def record(self, x, *a, **k):
        seen.append((np.asarray(x._data), np.asarray(self.weight._data),
                     self.top_k, self.capacity_factor, self.tot_expert))
        return orig(self, x, *a, **k)

    monkeypatch.setattr(jgate.BaseGate, "_route", record)
    return seen


def _reference_routing(x, w, k, cf, E, noise=None):
    """The reference gate's dense routing of a recorded input (its switch
    noise multiplied in where given)."""
    C = jgate._capacity(x.shape[0], E, k, cf)
    logits = jnp.asarray(x) @ jnp.asarray(w)
    if noise is not None:
        logits = logits * noise
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(
        x.dtype)
    combine, dispatch, _ = jgate.top_k_dispatch(probs, k, C)
    return np.asarray(combine), np.asarray(dispatch)


LOSS_CASES = {
    "aux": dict(),
    "no-aux": dict(moe_aux_loss_weight=0.0),
    "recompute-fused": dict(use_recompute=True, fuse_linear_cross_entropy=True,
                            ce_chunk_size=16),
    "switch-top1": dict(moe_gate="switch"),
    "naive-gqa": dict(moe_gate="naive", num_key_value_heads=2),
}


def _switch_noise_both(monkeypatch, T, E):
    """The switch gate's multiplicative noise while training: both packages
    draw the same U[0.9, 1.1] (the reference through ``jax.random.uniform``,
    the port through its seam ``gate._draw_noise``)."""
    noise = np.random.RandomState(9).uniform(0.9, 1.1, (T, E)).astype(
        np.float32)
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape, dtype=jnp.float32, minval=0., maxval=1.:
        jnp.asarray(noise, dtype))
    monkeypatch.setattr(tgate, "_draw_noise",
                        lambda kind, shape, eps, gen, dtype, device:
                        torch.tensor(noise, dtype=dtype, device=device))


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_gradients_and_routing_match_reference(monkeypatch, case):
    jm, tm = _pair(**LOSS_CASES[case])
    jseen = _record_reference_gate_inputs(monkeypatch)
    tseen = _record_port_routing(tm)
    x, y = _batch(3)
    if LOSS_CASES[case].get("moe_gate") == "switch":
        _switch_noise_both(monkeypatch, x.size, MOE["num_experts"])
    jm.train()
    tm.train()
    jl = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jl.backward()
    tl = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-5)
    np.testing.assert_allclose(float(tm.moe_aux_loss()),
                               float(jm.llama.moe_aux_loss().numpy()),
                               rtol=1e-6)
    assert len(tseen) == len(jseen) == 2
    noise = (jax.random.uniform(None, (x.size, MOE["num_experts"]))
             if LOSS_CASES[case].get("moe_gate") == "switch" else None)
    for i, (r, rec) in enumerate(zip(tseen, jseen)):
        jc, jd = _reference_routing(*rec, noise=noise)
        combine, dispatch = r.dense()
        np.testing.assert_array_equal(dispatch.numpy(), jd,
                                      err_msg=f"layer {i} slots")
        np.testing.assert_allclose(combine.detach().numpy(), jc, rtol=1e-6,
                                   atol=1e-7, err_msg=f"layer {i} weights")
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, nn.Linear)}
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        g = g.T if name in linear else g
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_aux_weight_changes_the_loss():
    """tests/test_moe_llama.py:30-47: the aux loss joins the labeled loss
    and reaches the gate and every expert weight."""
    _, tm = _pair()
    _, tm0 = _pair(moe_aux_loss_weight=0.0)
    x, y = _batch(4)
    tm.train()
    tm0.train()
    loss = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    loss0 = tm0(torch.from_numpy(x), labels=torch.from_numpy(y))
    aux = tm.moe_aux_loss()
    np.testing.assert_allclose(float(loss - loss0), 0.01 * float(aux),
                               rtol=1e-4)
    loss.backward()
    mlp = tm.llama.layers[0].mlp
    for p in (mlp.gate.weight, mlp.experts.w_gate, mlp.experts.w_up,
              mlp.experts.w_down):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0


def test_train_steps_with_make_loss_fn_match_reference():
    jm, tm = _pair()
    jopt = JaxAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01)
    jstep = JaxTrainStep(jm, jm.make_loss_fn(), jopt)
    topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                 weight_decay=0.01)
    tstep = TrainStep(tm, tm.make_loss_fn(), topt, device="cpu")
    for i in range(3):
        x, y = _batch(10 + i)
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
        tl = float(tstep(x, y))
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data), rtol=0,
                                   atol=3e-5, err_msg=name)


def test_make_loss_fn_adds_the_aux_loss_and_takes_the_fused_form():
    _, tm = _pair(fuse_linear_cross_entropy=True, ce_chunk_size=16)
    x, y = _batch(5)
    tm.train()
    h, w = tm(torch.from_numpy(x))
    crit = LlamaPretrainingCriterion(tm.config)
    bare = crit(h, w, torch.from_numpy(y))
    with_aux = tm.make_loss_fn()(h, w, torch.from_numpy(y))
    np.testing.assert_allclose(float(with_aux - bare),
                               0.01 * float(tm.moe_aux_loss()), rtol=1e-5)
    dense = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    dense.train()
    out = dense(torch.from_numpy(x))
    assert dense.moe_aux_loss() is None
    assert float(dense.make_loss_fn()(out, torch.from_numpy(y))) == \
        float(LlamaPretrainingCriterion()(out, torch.from_numpy(y)))


def test_generate_greedy_matches_reference():
    """tests/test_moe_llama.py:89-95, tokens against the reference's."""
    jm, tm = _pair(max_position_embeddings=256)
    jm.eval()
    ids = np.random.RandomState(7).randint(1, 128, (3, 9)).astype(np.int32)
    want = np.asarray(jm.generate(ids, max_new_tokens=8).numpy())
    got = tm.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_greedy_serve_matches_reference():
    """The ragged engine hands the MLP the reference's packed stream (the
    chunk budget plus one feed token a slot, pads included), so capacity
    and the pads' queue positions match and greedy tokens are identical."""
    jm, tm = _pair(max_position_embeddings=512)
    jm.eval()
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, 128, n).astype(np.int32)
               for n in (9, 200, 40, 77)]
    kw = dict(max_seqs=4, page_size=16, max_len=512, prefill_chunk=64)
    want = JaxEngine(jm, **kw).serve(prompts, max_new_tokens=12)
    got = ContinuousBatchingEngine(tm, device="cpu", **kw).serve(
        prompts, max_new_tokens=12)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"request {i}")


def test_moe_under_context_parallel_equals_no_mesh():
    """MoE with ring attention over sep 4: the MLP routes over the whole
    batch, as without a mesh, so the first step's loss is the no-mesh
    labeled forward's (tests/test_feature_composition.py:132-141)."""
    _, tm = _pair(seed=61, context_parallel=True, num_experts=2)
    x, y = _batch(61, B=8, S=16)
    tm.train()
    ref = float(tm(torch.from_numpy(x), labels=torch.from_numpy(y)))
    step = DistributedTrainStep(
        tm, tm.make_loss_fn(), AdamW(learning_rate=1e-3,
                                     parameters=tm.parameters()),
        mesh=build_mesh(sep=4, devices=["cpu"] * 4))
    np.testing.assert_allclose(float(step(x, y)), ref, rtol=2e-5, atol=2e-6)


def test_model_deep_copies_after_a_training_forward():
    """The last forward's aux loss holds its graph; a copy of the model
    starts without it and carries the same weights."""
    import copy

    _, tm = _pair()
    x, y = _batch(6)
    tm.train()
    tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    twin = copy.deepcopy(tm)
    assert twin.moe_aux_loss() is None and tm.moe_aux_loss() is not None
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              twin.named_parameters()):
        assert torch.equal(a, b), n
    assert twin.llama.layers[0].mlp.experts.w_up.is_distributed is True
