"""Port parity: the training recipe through both packages' ``TrainStep`` on
the CPU, at ``llama_tiny`` sizes, weights from the JAX model.

The recipe: AdamW (beta2 0.95, eps 1e-5, weight decay 0.1 off the norms),
``LinearWarmup(CosineAnnealingDecay)``, ``ClipGradByGlobalNorm`` set below
the gradients' norm (so every step clips), a dynamic ``GradScaler`` whose
first step overflows (the loss times 2^127, as in test_torch_amp.py),
``StepMetricsBus`` and ``PADDLE_DYNAMICS=1`` spilling every step; f32.

Tolerances (f32; the same operations summed in another order):
- losses of the finite steps within rtol 1e-5;
- the lr sequence, the skip pattern and the scale sequence equal;
- the gradients, read through the dynamics spills' per-group gradient
  norms (unscaled, before the clip), within rtol 1e-4; the parameter and
  update norms and update ratios within rtol 1e-4 (an update norm is a
  difference of parameters, so rtol 1e-4 of it is well inside atol
  3e-5 of a parameter); the loss EWMA and z-score within rtol 1e-5 and
  atol 1e-6;
- every parameter within atol 3e-5 (test_torch_training.py's limit);
- the metrics bus's window loss means within rtol 1e-5 and its records'
  fields and step numbers equal to the reference bus's;
- ``DistributedTrainStep`` under a sep-4 CPU mesh with the scaler and the
  bus against ``TrainStep`` with no mesh on the same model: losses within
  rtol 2e-5 (the reference's context-parallel oracle), the scale and skip
  sequences equal.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import clip as jclip
from paddle_tpu.utils.metrics_bus import StepMetricsBus as JaxBus
from paddle_tpu.utils.metrics_bus import counters as jax_counters
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import DistributedTrainStep, build_mesh
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.utils.metrics_bus import StepMetricsBus
from paddle_tpu_torch.utils.metrics_bus import counters as torch_counters

OVERFLOW = 2.0 ** 127
TRAIN_KW = dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                use_recompute=True, recompute_policy="full")
STEPS = 5


def _no_norm_decay(name):
    return "norm" not in name


def _optimizer(m, params):
    sched = m.lr.LinearWarmup(
        m.lr.CosineAnnealingDecay(1e-3, T_max=8, eta_min=1e-4),
        warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    clip = (tclip if m is topt else jclip).ClipGradByGlobalNorm(0.05)
    return m.AdamW(learning_rate=sched, beta2=0.95, epsilon=1e-5,
                   weight_decay=0.1, apply_decay_param_fun=_no_norm_decay,
                   parameters=params, grad_clip=clip)


def _batches(B=2, S=24):
    out = []
    for i in range(STEPS):
        ids = np.random.RandomState(60 + i).randint(0, 128, (B, S + 1))
        out.append((ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64),
                    np.array([OVERFLOW if i == 0 else 1.0], np.float32)))
    return out


def _jax_loss(h, w, y, m):
    return (JaxCrit()(h, w, y) * m).sum()


def _port_loss(h, w, y, m):
    return LlamaPretrainingCriterion()(h, w, y) * m.reshape(())


SCALER = dict(init_loss_scaling=2.0 ** 12, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)


def _run_both(monkeypatch, accumulate=1):
    monkeypatch.setenv("PADDLE_DYNAMICS", "1")
    monkeypatch.setenv("PADDLE_DYNAMICS_EVERY_STEPS", "1")
    # the buses' records carry the process-wide fault counters: start both
    # from zero, whatever earlier tests in this process counted
    jax_counters.reset("fault.")
    torch_counters.reset("fault.")
    paddle.seed(52)
    jm = JaxLlama(jax_tiny(**TRAIN_KW))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = load_paddle_tpu_state(LlamaForCausalLM(llama_tiny(**TRAIN_KW),
                                                device="cpu"), arrays)
    jo = _optimizer(jopt, jm.parameters())
    to = _optimizer(topt, tm.named_parameters())
    jbus, tbus = JaxBus(log_every=2), StepMetricsBus(log_every=2)
    jrec, trec = [], []
    jbus.subscribe(jrec.append)
    tbus.subscribe(trec.append)
    jstep = JaxTrainStep(jm, _jax_loss, jo, n_labels=2,
                         scaler=jamp.GradScaler(**SCALER), metrics_bus=jbus,
                         accumulate_steps=accumulate)
    tstep = TrainStep(tm, _port_loss, to, n_labels=2,
                      scaler=tamp.GradScaler(**SCALER), metrics_bus=tbus,
                      accumulate_steps=accumulate, device="cpu")
    out = {"j": [], "t": []}
    for b in _batches(B=2 * accumulate):
        lr = (jo.get_lr(), to.get_lr())
        jl = float(np.asarray(jstep(*[paddle.to_tensor(a) for a in b])._data))
        tl = float(tstep(*b))
        out["j"].append(dict(lr=lr[0], loss=jl,
                             scale=float(jstep._scaler_state["scale"]),
                             updates=int(jstep.opt_state["step"]),
                             dyn=jstep._dynamics.last))
        out["t"].append(dict(lr=lr[1], loss=tl,
                             scale=float(tstep._scaler_state["scale"]),
                             updates=to._global_step,
                             dyn=tstep._dynamics.last))
    return jm, tm, out, (jrec, trec), tstep


@pytest.mark.parametrize("accumulate", [1, 2])
def test_recipe_matches_reference(monkeypatch, accumulate):
    jm, tm, out, _, tstep = _run_both(monkeypatch, accumulate)
    for i, (j, t) in enumerate(zip(out["j"], out["t"])):
        assert t["lr"] == j["lr"], i
        assert t["scale"] == j["scale"], i
        assert t["updates"] == j["updates"] == max(i, 0), i
        if i == 0:
            assert not np.isfinite(t["loss"]) and not np.isfinite(j["loss"])
        else:
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    assert out["t"][0]["scale"] < SCALER["init_loss_scaling"]
    assert float(tstep.last_stats.factor) < 1.0      # the clip clipped
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data), rtol=0,
                                   atol=3e-5, err_msg=name)


def test_dynamics_spills_match_reference(monkeypatch):
    _, _, out, _, _ = _run_both(monkeypatch)
    for i, (j, t) in enumerate(zip(out["j"], out["t"])):
        jd, td = j["dyn"], t["dyn"]
        assert td["step"] == jd["step"] == i + 1
        assert td["updates"] == jd["updates"]
        assert td["nonfinite_steps"] == jd["nonfinite_steps"] == 1
        assert td["nonfinite_first"] == jd["nonfinite_first"]
        assert td["nonfinite_groups"] == jd["nonfinite_groups"]
        assert set(td["groups"]) == set(jd["groups"])
        for key in ("loss_ewma", "loss_z", "loss_z_max"):
            np.testing.assert_allclose(td[key], jd[key], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{i} {key}")
        if i == 0:
            continue        # the overflowed step's norms are inf/NaN
        np.testing.assert_allclose(td["grad_norm"], jd["grad_norm"],
                                   rtol=1e-4)
        for g, jg in jd["groups"].items():
            for key in ("grad_norm", "param_norm", "update_ratio"):
                np.testing.assert_allclose(td["groups"][g][key], jg[key],
                                           rtol=1e-4, err_msg=f"{i} {g} {key}")


def test_metrics_bus_matches_reference(monkeypatch):
    _, _, out, (jrec, trec), tstep = _run_both(monkeypatch)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] == [3, 5]
    for j, t in zip(jrec, trec):
        assert set(t) == set(j)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        assert t["tokens_per_sec"] > 0
    # the window mean of the losses after the first (skip_first) step
    np.testing.assert_allclose(
        trec[0]["loss"], np.mean([o["loss"] for o in out["t"][1:3]]),
        rtol=1e-6)
    assert tstep.metrics_bus.tokens_per_step == 2 * 24


def test_bus_reads_the_loss_only_when_it_emits():
    bus = StepMetricsBus(tokens_per_step=8, flops_per_token=10.0,
                         peak_flops=1e3, log_every=3, skip_first=1)
    records = []
    bus.subscribe(records.append)

    class Loss:
        reads = 0

        def __float__(self):
            Loss.reads += 1
            return 2.0

    for _ in range(4):
        bus.on_step(loss=Loss())
    assert Loss.reads == 3 and len(records) == 1
    assert records[0]["loss"] == 2.0 and "mfu" in records[0]
    bus.on_step(loss=Loss())
    assert Loss.reads == 3
    assert bus.summary()["steps"] == 3


def test_distributed_step_takes_the_scaler_and_bus():
    cfg = dict(TRAIN_KW, context_parallel=True)
    losses, scales, skips = [], [], []
    for mesh in (build_mesh(sep=4, devices=["cpu"] * 4), None):
        model = LlamaForCausalLM(llama_tiny(**cfg), device="cpu", seed=3)
        opt = _optimizer(topt, model.named_parameters())
        kw = dict(n_labels=2, scaler=tamp.GradScaler(**SCALER),
                  metrics_bus=StepMetricsBus(log_every=2))
        step = (DistributedTrainStep(model, _port_loss, opt, mesh=mesh, **kw)
                if mesh is not None
                else TrainStep(model, _port_loss, opt, device="cpu", **kw))
        run = [(float(step(*b)), float(step._scaler_state["scale"]),
                step.last_skipped) for b in _batches(S=32)]
        losses.append([r[0] for r in run])
        scales.append([r[1] for r in run])
        skips.append([r[2] for r in run])
        assert step.metrics_bus._step == STEPS
    assert scales[0] == scales[1] and skips[0] == skips[1]
    assert skips[0] == [True] + [False] * (STEPS - 1)
    np.testing.assert_allclose(losses[0][1:], losses[1][1:], rtol=2e-5)
