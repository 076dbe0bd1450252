"""Port parity: the training path of paddle_tpu_torch against the JAX
reference on the CPU, at ``llama_tiny`` sizes, with inputs and weights drawn
by numpy from seeds and fed to both packages.

Tolerances (f32 unless stated):
- ``fused_linear_cross_entropy``, chunked with a padded last chunk and
  ``ignore_index`` rows, every reduction: loss and the gradients of hidden
  and weight within rtol 1e-5, atol 1e-6 (summation order only);
- ``LlamaForCausalLM`` loss (fused CE; recompute off, "full" and "dots";
  MHA and GQA ``num_key_value_heads=2``): loss within rtol 1e-5, every
  parameter gradient within rtol 1e-4, atol 1e-6 (a two-layer forward and
  backward sums in another order in each framework);
- AdamW fed the same gradients for 3 steps, with a decay mask: f32
  parameters and moments within rtol 1e-6, atol 1e-7 (the bias-correction
  powers are f32 in both); bf16 parameters and moments (kept in bf16 by
  both) equal, or one bf16 ulp apart where the two frameworks round a
  product at another place;
- ``TrainStep`` over 3 steps against the reference's ``TrainStep``, also
  with ``accumulate_steps=2``: losses within rtol 1e-5, and every parameter
  (through ``export_paddle_tpu_state``) within atol 3e-5, 3% of the lr of
  1e-3: Adam moves an element by lr * m / sqrt(v), about lr whatever the
  gradient's size, so where a gradient is near zero its last digits,
  which the two frameworks sum in another order, set a visible share of
  the step;
- the non-finite guard skips an update (parameters, slots and step count
  hold) and counts consecutive and total skips, raising at the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import (
    fused_linear_cross_entropy as jax_fused_ce,
)
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.incubate.nn.functional import (
    fused_linear_cross_entropy,
)
from paddle_tpu_torch.jit_api import NonFiniteLossError, TrainStep
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.optimizer import AdamW


# -- fused linear cross-entropy ----------------------------------------------

def _ce_inputs(seed=0, n=13, h=16, v=40):
    rng = np.random.RandomState(seed)
    hid = rng.randn(2, n, h).astype(np.float32)
    w = (0.3 * rng.randn(h, v)).astype(np.float32)
    labels = rng.randint(0, v, (2, n)).astype(np.int64)
    labels[0, :4] = -100
    labels[1, 7] = -100
    return hid, w, labels


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("chunk", [8, 4096])
def test_fused_ce_matches_reference(reduction, chunk):
    hid, w, labels = _ce_inputs()
    cot = np.random.RandomState(1).randn(*labels.shape).astype(np.float32)
    jh = paddle.to_tensor(hid, stop_gradient=False)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jloss = jax_fused_ce(jh, jw, paddle.to_tensor(labels), chunk_size=chunk,
                         reduction=reduction)
    jobj = (jloss * paddle.to_tensor(cot)).sum() if reduction == "none" \
        else jloss
    jobj.backward()

    th = torch.from_numpy(hid.copy()).requires_grad_()
    tw = torch.from_numpy(w.copy()).requires_grad_()
    tloss = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                       chunk_size=chunk, reduction=reduction)
    tobj = (tloss * torch.from_numpy(cot)).sum() if reduction == "none" \
        else tloss
    tobj.backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tloss.detach().numpy(),
                               np.asarray(jloss._data), **tol)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh.grad._data),
                               **tol)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw.grad._data),
                               **tol)


def test_fused_ce_ignored_rows_add_nothing():
    hid, w, labels = _ce_inputs()
    labels[:] = -100
    th = torch.from_numpy(hid).requires_grad_()
    loss = fused_linear_cross_entropy(th, torch.from_numpy(w),
                                      torch.from_numpy(labels), chunk_size=8)
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert not th.grad.any()


# -- the model's loss and gradients -------------------------------------------

def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, nn.Linear)}


def _jax_model(seed=23, **kw):
    paddle.seed(seed)
    return JaxLlama(jax_tiny(**kw))


def _port_of(jm, device="cpu", **kw):
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    model = LlamaForCausalLM(llama_tiny(**kw), device=device)
    return load_paddle_tpu_state(model, arrays)


def _batch(seed, vocab=128, B=2, S=24):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)


MODEL_CASES = {
    "no-recompute": dict(fuse_linear_cross_entropy=True, ce_chunk_size=16),
    "recompute-full": dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                           use_recompute=True, recompute_policy="full"),
    "recompute-dots": dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                           use_recompute=True, recompute_policy="dots"),
    "gqa-recompute-full": dict(fuse_linear_cross_entropy=True,
                               num_key_value_heads=2, use_recompute=True,
                               recompute_policy="full"),
    "unfused": dict(),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_loss_and_gradients_match_reference(case):
    kw = MODEL_CASES[case]
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    x, y = _batch(3)
    jm.train()
    jloss = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    tm.train()
    tloss = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()),
                               rtol=1e-5)
    linear = _linear_names(tm)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        g = g.T if name in linear else g
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_fused_training_forward_hands_hidden_and_weight_to_the_loss():
    cfg = llama_tiny(fuse_linear_cross_entropy=True)
    model = LlamaForCausalLM(cfg, device="cpu").train()
    x, y = _batch(4)
    h, w = model(torch.from_numpy(x))
    assert h.shape == (2, 24, cfg.hidden_size)
    assert w.shape == (cfg.hidden_size, cfg.vocab_size)
    fused = LlamaPretrainingCriterion(cfg)(h, w, torch.from_numpy(y))
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    plain = LlamaPretrainingCriterion(cfg)(logits, torch.from_numpy(y))
    np.testing.assert_allclose(float(fused), float(plain), rtol=1e-5)


def test_flops_per_token_matches_reference():
    for kw in (dict(), dict(num_key_value_heads=2, tie_word_embeddings=True)):
        for seq in (None, 64):
            assert LlamaForCausalLM.flops_per_token(
                llama_tiny(**kw), seq_len=seq) == JaxLlama.flops_per_token(
                    jax_tiny(**kw), seq_len=seq)


# -- AdamW --------------------------------------------------------------------

def _adamw_case(dtype, seed=8):
    rng = np.random.RandomState(seed)
    params = {"w_decay": rng.randn(6, 5), "norm_skip": rng.randn(5)}
    grads = [{k: rng.randn(*v.shape) * (0.1 + i) for k, v in params.items()}
             for i in range(3)]
    cast = (lambda a: a.astype(np.float32))
    return ({k: cast(v) for k, v in params.items()},
            [{k: cast(v) for k, v in g.items()} for g in grads])


def _decay_fn(name):
    return "norm" not in name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_for_three_steps(dtype):
    params, grads = _adamw_case(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    kw = dict(learning_rate=0.05, weight_decay=0.1,
              apply_decay_param_fun=_decay_fn)
    jopt = JaxAdamW(**kw)
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    state = jopt.init_state({k: paddle.to_tensor(v)
                             for k, v in jparams.items()})
    update = jax.jit(lambda p, g, s, lr: jopt.apply_gradients(p, g, s, lr))

    tparams = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    topt = AdamW(parameters=list(tparams.items()), **kw)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        jparams, state = update(jparams, jg, state, 0.05)
        topt.apply_gradients([(tparams[k], torch.from_numpy(v).to(tdt))
                              for k, v in g.items()])
    assert topt._global_step == int(state["step"]) == 3
    for k, p in tparams.items():
        slots = topt._slots_for(p)
        pairs = [(p, jparams[k]), (slots["moment1"], state["slots"][k][
            "moment1"]), (slots["moment2"], state["slots"][k]["moment2"])]
        for got, want in pairs:
            assert got.dtype == tdt
            want = np.asarray(want.astype(jnp.float32))
            got = got.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                           err_msg=k)
            else:   # at most one bf16 ulp (2^-7 relative) apart
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                           err_msg=k)


def test_adamw_decay_mask_and_no_weight_decay():
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3, requires_grad=True)
    b.no_weight_decay = True
    opt = AdamW(learning_rate=0.1, weight_decay=0.5, parameters=[a, b])
    a.grad = torch.zeros(3)
    b.grad = torch.zeros(3)
    opt.step()
    np.testing.assert_allclose(a.detach().numpy(), 0.95, rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), 1.0)


# -- TrainStep ------------------------------------------------------------------

TRAIN_KW = dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                use_recompute=True, recompute_policy="full")


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_matches_reference_for_three_steps(accumulate):
    jm = _jax_model(**TRAIN_KW)
    tm = _port_of(jm, **TRAIN_KW)
    jopt = JaxAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01)
    jstep = JaxTrainStep(jm, lambda *a: JaxCrit()(*a), jopt,
                         accumulate_steps=accumulate)
    topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                 weight_decay=0.01)
    tstep = TrainStep(tm, LlamaPretrainingCriterion(), topt,
                      accumulate_steps=accumulate, device="cpu")
    for i in range(3):
        x, y = _batch(10 + i, B=4)
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
        tl = float(tstep(x, y))
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data), rtol=0,
                                   atol=3e-5, err_msg=name)


def test_run_steps_is_a_loop_of_steps():
    x = np.stack([_batch(20 + i)[0] for i in range(3)])
    y = np.stack([_batch(20 + i)[1] for i in range(3)])
    losses = []
    for stacked in (True, False):
        model = LlamaForCausalLM(llama_tiny(**TRAIN_KW), device="cpu")
        step = TrainStep(model, LlamaPretrainingCriterion(),
                         AdamW(learning_rate=1e-3,
                               parameters=model.parameters()),
                         device="cpu")
        if stacked:
            losses.append(step.run_steps(x, y, n=3, stacked=True))
        else:
            losses.append(torch.stack([step(x[i], y[i]) for i in range(3)]))
    assert losses[0].shape == (3,)
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)


def test_nonfinite_guard_skips_and_counts():
    model = LlamaForCausalLM(llama_tiny(**TRAIN_KW), device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, LlamaPretrainingCriterion(), opt, device="cpu",
                     nonfinite_tolerance=3)
    x, y = _batch(30)
    step(x, y)
    assert step.nonfinite == {"consec": 0, "total": 0}
    emb = model.llama.embed_tokens.weight
    good = emb.detach().clone()

    def poisoned_step():
        with torch.no_grad():
            emb[int(x[0, 0])] = float("nan")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        slots = {n: {k: v.clone() for k, v in opt._slots_for(p).items()
                     if isinstance(v, torch.Tensor)}
                 for n, p in model.named_parameters()}
        n_updates = opt._global_step
        loss = step(x, y)
        assert not torch.isfinite(loss)
        assert opt._global_step == n_updates
        for n, p in model.named_parameters():
            torch.testing.assert_close(p, before[n], rtol=0, atol=0,
                                       equal_nan=True)
            for k, v in slots[n].items():
                torch.testing.assert_close(opt._slots_for(p)[k], v, rtol=0,
                                           atol=0)
        with torch.no_grad():
            emb.copy_(good)

    poisoned_step()
    assert step.nonfinite == {"consec": 1, "total": 1}
    step(x, y)
    assert step.nonfinite == {"consec": 0, "total": 1}
    good = emb.detach().clone()
    poisoned_step()
    poisoned_step()
    with torch.no_grad():
        emb[int(x[0, 0])] = float("nan")
    with pytest.raises(NonFiniteLossError, match="3 consecutive"):
        step(x, y)
    assert step.nonfinite == {"consec": 3, "total": 4}


def test_nonfinite_guard_can_be_turned_off():
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    step = TrainStep(model, LlamaPretrainingCriterion(),
                     AdamW(parameters=model.parameters()), device="cpu",
                     nonfinite_guard=False)
    assert step.nonfinite is None
