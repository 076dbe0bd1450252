"""Port parity: three faults of the port repaired against the JAX reference
on the CPU, at ``llama_tiny`` sizes, inputs drawn by numpy from seeds.

- ``DistributedTrainStep.run_steps`` runs its steps under the mesh
  (reference distributed/train_step.py:364): under ``build_mesh(sep=4)``
  a context-parallel model's ``run_steps`` calls ``ring_flash_attention``
  2 x layers x n times (forward and recompute), its losses equal the
  reference's ``run_steps`` on its sep mesh within rtol 1e-5 (f32, the
  two differ in summation order only), and a sequence of 30 raises the
  reference's ValueError in both packages;
- the non-finite guard reads the reference's ``PADDLE_NONFINITE_TOLERANCE``
  and ``PADDLE_NONFINITE_CHECK_EVERY`` (jit_api.py:28-33, :209-222): at
  tolerance 0 the guard is off in both packages and the gradient-norm
  kernel is not launched for it; under forced NaN losses both raise
  NonFiniteLossError on the same step; the host checks the counters once
  per max(tolerance, 16) dispatches by default, once per CHECK_EVERY when
  set, and after every ``run_steps``;
- the eleven plain optimizer rules on a bf16 parameter without master
  weights, 5 updates, equal the reference's bit for bit (parameters and
  every slot): each Python scalar meets a bf16 tensor rounded to bf16, as
  JAX's weak typing rounds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt_mod
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.train_step import (
    DistributedTrainStep as JaxDistributedTrainStep,
)
from paddle_tpu.jit_api import NonFiniteLossError as JaxNonFiniteLossError
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import jit_api
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.distributed import DistributedTrainStep, build_mesh
from paddle_tpu_torch.jit_api import NonFiniteLossError, TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.optimizer import AdamW

SEP = 4
TRAIN_KW = dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                use_recompute=True, recompute_policy="full")


def _jax_model(seed=51, **kw):
    paddle.seed(seed)
    return JaxLlama(jax_tiny(num_hidden_layers=2, **kw))


def _port_of(jm, **kw):
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=2, **kw),
                             device="cpu")
    return load_paddle_tpu_state(model, arrays)


def _batch(seed, B=2, S=32, vocab=128):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)


# -- repair 1: DistributedTrainStep.run_steps under the mesh ----------------

def test_run_steps_under_sep_goes_through_the_ring(monkeypatch):
    kw = dict(context_parallel=True, **TRAIN_KW)
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    x, y = _batch(40)
    with JM.mesh_guard(JM.build_mesh(sep=SEP)):
        jstep = JaxDistributedTrainStep(
            jm, lambda *a: JaxCrit()(*a),
            JaxAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                     weight_decay=0.01))
        want = np.asarray(jstep.run_steps(paddle.to_tensor(x),
                                          paddle.to_tensor(y), n=2).numpy())
    calls = []
    ring = tllama.ring_flash_attention

    def counted(*a, **k):
        calls.append(1)
        return ring(*a, **k)

    monkeypatch.setattr(tllama, "ring_flash_attention", counted)
    tstep = DistributedTrainStep(
        tm, LlamaPretrainingCriterion(),
        AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
              weight_decay=0.01),
        mesh=build_mesh(sep=SEP, devices=["cpu"] * SEP))
    got = tstep.run_steps(x, y, n=2)
    # forward and recompute in each of 2 layers, 2 steps
    assert len(calls) == 2 * 2 * 2
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)


def test_run_steps_refuses_a_sequence_the_sep_axis_does_not_divide():
    kw = dict(context_parallel=True)
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    x, y = _batch(41, S=30)
    msg = "sequence length 30 is not divisible by the sep axis size 4"
    with JM.mesh_guard(JM.build_mesh(sep=SEP)):
        jstep = JaxDistributedTrainStep(
            jm, lambda *a: JaxCrit()(*a),
            JaxAdamW(learning_rate=1e-3, parameters=jm.parameters()))
        with pytest.raises(ValueError, match=msg):
            jstep.run_steps(paddle.to_tensor(x), paddle.to_tensor(y), n=2)
    tstep = DistributedTrainStep(
        tm, LlamaPretrainingCriterion(),
        AdamW(learning_rate=1e-3, parameters=tm.named_parameters()),
        mesh=build_mesh(sep=SEP, devices=["cpu"] * SEP))
    with pytest.raises(ValueError, match=msg):
        tstep.run_steps(x, y, n=2)
    stacked = (np.stack([x, x]), np.stack([y, y]))
    with pytest.raises(ValueError, match=msg):
        tstep.run_steps(*stacked, n=2, stacked=True)


# -- repair 2: the guard's environment variables ----------------------------

def _guard_pair(seed=52):
    jm = _jax_model(seed)
    tm = _port_of(jm)
    jstep = JaxTrainStep(jm, lambda *a: JaxCrit()(*a),
                         JaxAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters()))
    tstep = TrainStep(tm, LlamaPretrainingCriterion(),
                      AdamW(learning_rate=1e-3,
                            parameters=tm.named_parameters()),
                      device="cpu")
    return jm, tm, jstep, tstep


def test_tolerance_zero_turns_the_guard_off(monkeypatch):
    """``PADDLE_NONFINITE_TOLERANCE=0``: no guard in either package, and
    with no scaler, clip or dynamics the step launches the gradient-norm
    kernel not at all (at the default tolerance, once a step)."""
    launches = []
    real = jit_api.grad_sumsq

    def counted(*a, **k):
        launches.append(1)
        return real(*a, **k)

    monkeypatch.setattr(jit_api, "grad_sumsq", counted)
    x, y = _batch(42, S=16)
    for tol, want in (("0", 0), ("3", 2)):
        monkeypatch.setenv("PADDLE_NONFINITE_TOLERANCE", tol)
        launches.clear()
        _, _, jstep, tstep = _guard_pair()
        assert (jstep._nf_state is None) == (tstep.nonfinite is None) \
            == (tol == "0")
        tstep(x, y)
        tstep(x, y)
        assert len(launches) == want


def _poison(model, row):
    """Set embedding row ``row`` to NaN: every later loss is NaN, and the
    skipped updates leave it so."""
    w = model.llama.embed_tokens.weight
    if isinstance(w, torch.Tensor):
        with torch.no_grad():
            w[row] = float("nan")
    else:
        w._data = w._data.at[row].set(jnp.nan)


@pytest.mark.parametrize("check_every", [None, "3"])
def test_guard_raises_on_the_reference_step(monkeypatch, check_every):
    """Tolerance 2 under forced NaN losses (an embedding row of the batch
    set to NaN after two clean steps): the counters are read at the
    cadence, every 16 dispatches by default (consec 14 at dispatch 16),
    else every 3 (consec 1 at dispatch 3, 4 at 6), so both packages raise
    on the same later step, not on the second NaN step."""
    monkeypatch.setenv("PADDLE_NONFINITE_TOLERANCE", "2")
    if check_every:
        monkeypatch.setenv("PADDLE_NONFINITE_CHECK_EVERY", check_every)
    jm, tm, jstep, tstep = _guard_pair()
    x, y = _batch(43, S=16)
    raised = {}
    for name, model, step, err in (
            ("jax", jm, jstep, JaxNonFiniteLossError),
            ("port", tm, tstep, NonFiniteLossError)):
        for i in range(1, 21):
            if i == 3:
                _poison(model, int(x[0, 0]))
            args = ((paddle.to_tensor(x), paddle.to_tensor(y))
                    if name == "jax" else (x, y))
            try:
                step(*args)
            except err:
                raised[name] = i
                break
    want = 16 if check_every is None else 6
    assert raised == {"jax": want, "port": want}
    assert tstep.nonfinite == {"consec": want - 2, "total": want - 2}


def test_guard_reads_its_counters_at_the_cadence(monkeypatch):
    """The host reads the counters once per max(tolerance, 16) dispatches
    (tolerance 3: 16), once per CHECK_EVERY when set, and once after every
    ``run_steps`` dispatch whatever the count."""
    x, y = _batch(44, S=8)
    for every, steps, want in ((None, 34, 2), ("5", 12, 2), ("1", 3, 3)):
        monkeypatch.delenv("PADDLE_NONFINITE_CHECK_EVERY", raising=False)
        if every:
            monkeypatch.setenv("PADDLE_NONFINITE_CHECK_EVERY", every)
        model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1),
                                 device="cpu")
        step = TrainStep(model, LlamaPretrainingCriterion(),
                         AdamW(parameters=model.parameters()), device="cpu")
        reads = []
        real = step._nf_read
        step._nf_read = lambda: reads.append(1) or real()
        for _ in range(steps):
            step(x, y)
        assert len(reads) == want, every
        step.run_steps(x, y, n=4)
        assert len(reads) == want + 1


# -- repair 3: the eleven plain rules in bf16, bit for bit ------------------

# rule -> constructor kwargs, the same in both packages (weight decay on
# two rules: L2 on SGD, L1 on Momentum)
PLAIN_RULES = {
    "SGD": dict(weight_decay=0.01),
    "Momentum": dict(momentum=0.9, use_nesterov=True),
    "Adagrad": dict(initial_accumulator_value=0.1),
    "RMSProp": dict(centered=True, momentum=0.5),
    "Adadelta": dict(),
    "Adamax": dict(),
    "Lamb": dict(exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "NAdam": dict(),
    "RAdam": dict(),
    "Rprop": dict(),
    "ASGD": dict(),
}
LR = 0.05


def _kw(rule, pkg):
    kw = dict(PLAIN_RULES[rule])
    if rule == "Momentum":
        kw["weight_decay"] = pkg.L1Decay(0.02)
    return kw


@pytest.mark.parametrize("rule", sorted(PLAIN_RULES))
def test_plain_rule_in_bf16_matches_reference_bit_for_bit(rule):
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "norm_b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (0.1 + i)).astype(np.float32)
              for k, v in params.items()} for i in range(5)]
    opt = getattr(jopt_mod, rule)(learning_rate=LR, **_kw(rule, jopt_mod))
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    state = opt.init_state({k: paddle.to_tensor(v) for k, v in jp.items()})
    # the lr enters as the reference's step passes it: a weakly typed f32
    update = jax.jit(lambda p, g, s, lr: opt.apply_gradients(p, g, s, lr))
    tp = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in params.items()}
    topt = getattr(topt_mod, rule)(learning_rate=LR,
                                   parameters=list(tp.items()),
                                   **_kw(rule, topt_mod))
    for i, g in enumerate(grads):
        jp, state = update(jp, {k: jnp.asarray(v).astype(jnp.bfloat16)
                                for k, v in g.items()}, state, LR)
        topt.apply_gradients([(tp[k], torch.from_numpy(v).to(torch.bfloat16))
                              for k, v in g.items()])
        for k, p in tp.items():
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                p.float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
                err_msg=f"{rule} {k} update {i + 1}")
            slots = topt._slots_for(p)
            for name, want in state["slots"][k].items():
                got = slots[name]
                if not isinstance(got, torch.Tensor):
                    assert got == float(want), (rule, k, name)
                    continue
                assert str(got.dtype).split(".")[-1] == str(
                    jnp.asarray(want).dtype), (rule, k, name)
                np.testing.assert_array_equal(
                    got.float().numpy(),
                    np.asarray(jnp.asarray(want).astype(jnp.float32)),
                    err_msg=f"{rule} {k} {name} update {i + 1}")
