"""Port parity: AMP (``paddle_tpu_torch.amp``) against the JAX reference on
the CPU.

Tolerances:
- ``GradScaler`` eager (``scale``, ``minimize``: unscale, skip, update) on
  a small f32 model with an overflow forced at two steps: the scale
  sequence, the skipped steps and the scaler's ``state_dict`` equal; the
  weights within rtol 1e-6 (the same f32 operations);
- ``GradScaler`` inside ``TrainStep`` (``llama_tiny``, f32, fused CE, an
  overflow forced at steps 1 and 3): the scale sequence and the skip
  pattern equal, losses of the finite steps within rtol 1e-5, every
  parameter within atol 3e-5 (test_torch_training.py's limits); the
  state machine on the device against the reference's ``update_state``,
  step for step, exactly;
- ``auto_cast`` and ``decorate``: the dtypes the reference gives, exactly.

An overflow is forced by multiplying a step's loss by 2^127: f32 has no
finite loss scale that overflows these gradients (the largest is about
1e-2 of the scale), and a loss past f32's range is what an fp16 overflow
looks like.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.nn.functional.common import linear as tlinear
from paddle_tpu_torch.tensor.linalg import matmul as tmatmul

OVERFLOW = 2.0 ** 127
SCALER_KW = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                 decr_every_n_nan_or_inf=1)


def _eager_data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(5, 4).astype(np.float32),
            rng.randn(4, 3).astype(np.float32))


def test_grad_scaler_eager_matches_reference():
    x, w0 = _eager_data()
    mults = [1.0, OVERFLOW, 1.0, 1.0, OVERFLOW, 1.0]
    jw = paddle.to_tensor(w0, stop_gradient=False)
    jo = jopt.SGD(learning_rate=0.1, parameters=[jw])
    js = jamp.GradScaler(**SCALER_KW)
    tw = torch.from_numpy(w0.copy()).requires_grad_()
    to = topt.SGD(learning_rate=0.1, parameters=[tw])
    ts = tamp.GradScaler(**SCALER_KW)
    seq = []
    for m in mults:
        jl = ((paddle.to_tensor(x).matmul(jw)) ** 2).mean() * m
        js.minimize(jo, js.scale(jl))
        jo.clear_grad()
        tl = ((torch.from_numpy(x) @ tw) ** 2).mean() * m
        ts.minimize(to, ts.scale(tl))
        to.clear_grad()
        seq.append((ts._scale, ts._found_inf))
        assert (ts._scale, ts._found_inf) == (js._scale, js._found_inf)
    assert [f for _, f in seq] == [m == OVERFLOW for m in mults]
    assert ts.state_dict() == js.state_dict()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw._data),
                               rtol=1e-6)
    fresh = tamp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh._scale == ts._scale and fresh._good_steps == ts._good_steps


def test_scaler_state_machine_matches_reference():
    js, ts = jamp.GradScaler(**SCALER_KW), tamp.GradScaler(**SCALER_KW)
    jst, tst = js.init_state(), ts.init_state("cpu")
    for finite in (True, False, True, True, True, False, False, True):
        jst = js.update_state(jst, jnp.asarray(finite))
        tst = ts.update_state(tst, torch.tensor(finite))
        for k in ("scale", "good", "bad"):
            assert float(tst[k]) == float(jst[k]), k
        assert tst["scale"].dtype == torch.float32
        assert tst["good"].dtype == torch.int32


TRAIN_KW = dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                use_recompute=True, recompute_policy="full")


def _port_of(jm, **kw):
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return load_paddle_tpu_state(LlamaForCausalLM(llama_tiny(**kw),
                                                  device="cpu"), arrays)


def _batches(n, seed=40, B=2, S=24, overflow=(0,)):
    out = []
    for i in range(n):
        ids = np.random.RandomState(seed + i).randint(0, 128, (B, S + 1))
        mult = np.array([OVERFLOW if i in overflow else 1.0], np.float32)
        out.append((ids[:, :-1].astype(np.int32),
                    ids[:, 1:].astype(np.int64), mult))
    return out


def _jax_loss(h, w, y, m):
    return (JaxCrit()(h, w, y) * m).sum()


def _port_loss(h, w, y, m):
    return LlamaPretrainingCriterion()(h, w, y) * m.reshape(())


@pytest.mark.parametrize("accumulate", [1, 2])
def test_grad_scaler_in_train_step_matches_reference(accumulate):
    paddle.seed(31)
    jm = JaxLlama(jax_tiny(**TRAIN_KW))
    tm = _port_of(jm, **TRAIN_KW)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01)
    jstep = JaxTrainStep(jm, _jax_loss, jo, n_labels=2,
                         scaler=jamp.GradScaler(**SCALER_KW),
                         accumulate_steps=accumulate)
    to = topt.AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                    weight_decay=0.01)
    tstep = TrainStep(tm, _port_loss, to, n_labels=2,
                      scaler=tamp.GradScaler(**SCALER_KW),
                      accumulate_steps=accumulate, device="cpu")
    assert tstep.nonfinite is None      # off under a scaler
    updates = 0
    for i, b in enumerate(_batches(5, B=4, overflow=(0, 3))):
        jl = float(np.asarray(jstep(*[paddle.to_tensor(a) for a in b])._data))
        tl = float(tstep(*b))
        skipped = int(jstep.opt_state["step"]) == updates
        updates = int(jstep.opt_state["step"])
        assert tstep.last_skipped == skipped == (i in (0, 3)), i
        assert float(tstep._scaler_state["scale"]) == float(
            jstep._scaler_state["scale"]), i
        if skipped:
            assert not np.isfinite(tl) and not np.isfinite(jl)
        else:
            np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    assert to._global_step == updates == 3
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data), rtol=0,
                                   atol=3e-5, err_msg=name)


def test_auto_cast_dtypes_match_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    jx, jw, jb = (paddle.to_tensor(a) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))

    def dtypes():
        jd = [str(JF.linear(jx, jw).dtype), str(JF.linear(jx, jw, jb).dtype),
              str(paddle.matmul(jx, jw).dtype)]
        td = [tlinear(tx, tw).dtype, tlinear(tx, tw, tb).dtype,
              tmatmul(tx, tw).dtype]
        return jd, [str(d).removeprefix("torch.") for d in td]

    base = dtypes()
    assert base[1] == ["float32"] * 3
    assert not tamp.is_autocast_enabled()
    for kw in (dict(), dict(dtype="float16"),
               dict(custom_black_list={"linear"}),
               dict(enable=False)):
        with jamp.auto_cast(**kw), tamp.auto_cast(**kw):
            jd, td = dtypes()
            assert tamp.is_autocast_enabled() == kw.get("enable", True)
        assert jd == td, kw
    assert not tamp.is_autocast_enabled()
    with tamp.autocast():
        model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1),
                                 device="cpu")
        q = model.llama.layers[0].self_attn.q_proj(torch.zeros(2, 64))
    assert q.dtype == torch.bfloat16
    assert tamp.is_bfloat16_supported()
    assert tamp.is_float16_supported() == jamp.is_float16_supported()


def test_decorate_casts_the_model_and_sets_master_weights():
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    opt = topt.AdamW(parameters=model.parameters())
    m2, o2 = tamp.decorate(model, opt, level="O2", dtype="bfloat16")
    assert m2 is model and o2 is opt and opt._multi_precision
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    p = next(model.parameters())
    assert opt._slots_for(p)["master_weight"].dtype == torch.float32
    assert tamp.decorate(model, level="O1") is model
    jm = JaxLlama(jax_tiny(num_hidden_layers=1))
    jo = jopt.AdamW(parameters=jm.parameters())
    jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    assert {str(p.dtype) for p in jm.parameters()} == {"bfloat16"}
    assert jo._multi_precision
