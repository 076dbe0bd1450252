"""Port parity: the optimizer options of ``paddle_tpu_torch`` against the
JAX reference on the CPU, inputs drawn by numpy from seeds and fed to both.

Tolerances:
- the 13 rules, 3 updates through ``apply_gradients`` (the reference's
  jitted with a traced lr, as its ``TrainStep`` runs it), with L2 or L1
  decay on some: f32 parameters and every slot within rtol 1e-5, atol
  1e-7 (the same operations in the same order; XLA and PyTorch may round
  a transcendental, a power or Lamb's norms an ulp apart); bf16 parameters
  with f32 master weights (``multi_precision``): masters and slots the
  same, and the bf16 parameter equal to its master rounded once, within
  one bf16 ulp (2^-7 relative) of the reference's;
- the clips on f32 gradients, eager: rtol 1e-6 (``ClipGradByGlobalNorm``'s
  sums are f64 in the port, f32 in the reference);
- the gradient-norm kernel's plain version against the JAX math: sums
  rtol 1e-6, flags, the clip factor rtol 1e-6; a finite value whose
  square overflows gives an infinite sum and no flag;
- the AdamW kernel's plain version (master instance, unscale, clip
  factor, L2) against the reference's rule on the same transformed
  gradient: rtol 1e-6, atol 1e-8; its dynamics sums (p_old^2 and the
  update's squares) rtol 1e-6;
- ``L1Decay`` and ``L2Decay`` on f32 and bf16 parameters: equal bit for
  bit (the coefficient rounded to the parameter's dtype first, as the
  reference's Python scalar is, and as the AdamW kernel takes it);
- param groups are flattened in order (the repair: the port used to take
  each group dict for a parameter).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt_mod
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops import adamw as tadamw
from paddle_tpu_torch.ops import grad_norm as tgn


def _decay_fn(name):
    return "norm" not in name


def _no_decay_1d(p):
    return len(p.shape) == 1


# rule -> constructor kwargs, the same in both packages
RULES = {
    "SGD": dict(weight_decay=0.01),
    "Momentum": dict(momentum=0.9, use_nesterov=True),
    "Adam": dict(),
    "AdamW": dict(weight_decay=0.1, apply_decay_param_fun=_decay_fn),
    "Adagrad": dict(initial_accumulator_value=0.1),
    "RMSProp": dict(centered=True, momentum=0.5),
    "Adadelta": dict(),
    "Adamax": dict(),
    "Lamb": dict(exclude_from_weight_decay_fn=_no_decay_1d),
    "NAdam": dict(),
    "RAdam": dict(),
    "Rprop": dict(),
    "ASGD": dict(),
}
L1_RULES = {"Momentum", "Adam"}     # these run with L1Decay(0.02)
LR = 0.05


def _case(seed=11):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "norm_b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (0.1 + i)).astype(np.float32)
              for k, v in params.items()} for i in range(3)]
    return params, grads


def _kw(rule, side):
    kw = dict(RULES[rule])
    if rule in L1_RULES:
        kw["weight_decay"] = (jopt_mod if side == "jax"
                              else topt_mod).L1Decay(0.02)
    return kw


def _run_reference(rule, params, grads, master):
    dt = jnp.bfloat16 if master else jnp.float32
    opt = getattr(jopt_mod, rule)(learning_rate=LR, multi_precision=master,
                                  **_kw(rule, "jax"))
    jp = {k: jnp.asarray(v).astype(dt) for k, v in params.items()}
    state = opt.init_state({k: paddle.to_tensor(v) for k, v in jp.items()})
    update = jax.jit(lambda p, g, s, lr: opt.apply_gradients(p, g, s, lr))
    for g in grads:
        jg = {k: jnp.asarray(v).astype(dt) for k, v in g.items()}
        jp, state = update(jp, jg, state, LR)
    return jp, state


@pytest.mark.parametrize("master", [False, True], ids=["f32", "bf16-master"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_reference_for_three_updates(rule, master):
    params, grads = _case()
    jp, state = _run_reference(rule, params, grads, master)
    dt = torch.bfloat16 if master else torch.float32
    tp = {k: torch.from_numpy(v).to(dt) for k, v in params.items()}
    opt = getattr(topt_mod, rule)(learning_rate=LR,
                                  parameters=list(tp.items()),
                                  multi_precision=master, **_kw(rule, "port"))
    for g in grads:
        opt.apply_gradients([(tp[k], torch.from_numpy(v).to(dt))
                             for k, v in g.items()])
    assert opt._global_step == int(state["step"]) == 3
    for k, p in tp.items():
        assert p.dtype == dt
        slots = opt._slots_for(p)
        want_slots = state["slots"][k]
        assert set(slots) == set(want_slots), k
        for name, want in want_slots.items():
            got = slots[name]
            if not isinstance(got, torch.Tensor):
                assert got == float(want), (k, name)
                continue
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                rtol=1e-5, atol=1e-7, err_msg=f"{rule} {k} {name}")
        want_p = np.asarray(jp[k].astype(jnp.float32))
        if master:
            assert slots["master_weight"].dtype == torch.float32
            torch.testing.assert_close(p, slots["master_weight"].to(dt),
                                       rtol=0, atol=0)
            np.testing.assert_allclose(p.float().numpy(), want_p,
                                       rtol=2 ** -7, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{rule} {k}")


def test_param_groups_are_flattened():
    rng = np.random.RandomState(3)
    vals = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    grad = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]

    def run(parameters, ps):
        opt = topt_mod.AdamW(learning_rate=0.1, parameters=parameters)
        for p, g in zip(ps, grad):
            p.grad = torch.from_numpy(g)
        opt.step()
        return opt

    grouped = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    flat = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    opt = run([{"params": grouped[:2]}, {"params": grouped[2:]}], grouped)
    run(flat, flat)
    assert opt.parameters() == grouped
    for a, b in zip(grouped, flat):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jps = [paddle.to_tensor(v) for v in vals]
    ref = jopt_mod.AdamW(learning_rate=0.1,
                         parameters=[{"params": jps[:2]}, {"params": jps[2:]}])
    assert ref._parameter_list == jps


def test_minimize_and_clear_gradients():
    p = torch.ones(3, requires_grad=True)
    opt = topt_mod.SGD(learning_rate=0.5, parameters=[p])
    loss = (p * torch.tensor([1.0, 2.0, 3.0])).sum()
    assert opt.minimize(loss) == (None, None)
    np.testing.assert_allclose(p.detach().numpy(), [0.5, 0.0, -0.5])
    assert not p.grad.any()
    opt.clear_gradients(set_to_zero=False)
    assert p.grad is None


def test_state_dict_round_trip_with_master_weights():
    rng = np.random.RandomState(5)
    p = torch.from_numpy(rng.randn(8).astype(np.float32)).to(torch.bfloat16)
    opt = topt_mod.AdamW(learning_rate=topt_mod.lr.ExponentialDecay(
        0.1, 0.9), parameters=[p], multi_precision=True)
    opt.apply_gradients([(p, torch.ones(8, dtype=torch.bfloat16))])
    sd = opt.state_dict()
    assert {"param_0.master_weight", "param_0.moment1", "param_0.moment2",
            "LR_Scheduler", "global_step"} <= set(sd)
    q = p.clone()
    fresh = topt_mod.AdamW(learning_rate=topt_mod.lr.ExponentialDecay(
        0.1, 0.9), parameters=[q], multi_precision=True)
    fresh.set_state_dict(sd)
    for name in ("master_weight", "moment1", "moment2"):
        torch.testing.assert_close(fresh._slots_for(q)[name],
                                   opt._slots_for(p)[name], rtol=0, atol=0)
    assert fresh._global_step == 1


# -- the clips --------------------------------------------------------------

def _pairs(seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 3).astype(np.float32),
             rng.randn(4, 3).astype(np.float32) * s) for s in (0.5, 2.0, 3.0)]


CLIPS = {
    "global": lambda m: m.ClipGradByGlobalNorm(1.5),
    "norm": lambda m: m.ClipGradByNorm(1.0),
    "value": lambda m: m.ClipGradByValue(0.8, min=-0.5),
}


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_matches_reference(kind):
    pairs = _pairs()
    want = CLIPS[kind](jclip)([(paddle.to_tensor(p), paddle.to_tensor(g))
                               for p, g in pairs])
    got = CLIPS[kind](tclip)([(torch.from_numpy(p), torch.from_numpy(g))
                              for p, g in pairs])
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), rtol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_reference(norm_type):
    pairs = _pairs(9)
    jps, tps = [], []
    for p, g in pairs:
        jp = paddle.to_tensor(p, stop_gradient=False)
        jp.grad = paddle.to_tensor(g)
        tp = torch.from_numpy(p.copy()).requires_grad_()
        tp.grad = torch.from_numpy(g.copy())
        jps.append(jp)
        tps.append(tp)
    jt = jclip.clip_grad_norm_(jps, 2.0, norm_type=norm_type)
    tt = tclip.clip_grad_norm_(tps, 2.0, norm_type=norm_type)
    np.testing.assert_allclose(float(tt), float(np.asarray(jt._data)),
                               rtol=1e-6)
    jclip.clip_grad_value_(jps, 0.3)
    tclip.clip_grad_value_(tps, 0.3)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad._data), rtol=1e-6)


def test_optimizer_step_clips_first():
    pairs = _pairs(4)
    ps = [torch.from_numpy(p.copy()).requires_grad_() for p, _ in pairs]
    for p, (_, g) in zip(ps, pairs):
        p.grad = torch.from_numpy(g.copy())
    opt = topt_mod.SGD(learning_rate=1.0, parameters=ps,
                       grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    opt.step()
    gn = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                     for _, g in pairs))
    for p, (p0, g) in zip(ps, pairs):
        np.testing.assert_allclose(p.detach().numpy(), p0 - g / gn,
                                   rtol=1e-5, atol=1e-6)


# -- the kernels' plain versions against the JAX math -------------------------

def _grad_list(seed=2):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*s).astype(np.float32) * 0.3
           for s in ((37, 5), (1,), (7,), (4, 9))]
    out[1][0] = 1e30            # finite, its square overflows f32
    out[2][3] = np.nan
    out[3][2, 4] = -np.inf
    return out


@pytest.mark.parametrize("scale", [None, 1024.0, 3.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_sumsq_plain_matches_jax_math(scale, dtype):
    arrs = _grad_list()
    clean = [a for i, a in enumerate(arrs) if i in (0, 1)]
    for case in (arrs, clean):
        jg = [jnp.asarray(a).astype(dtype) for a in case]
        tg = [torch.tensor(np.asarray(g.astype(jnp.float32))).to(
            getattr(torch, dtype)) for g in jg]
        ts = None if scale is None else torch.tensor(scale)
        st = tgn.grad_sumsq(tg, scale=ts, clip_norm=1.5,
                            groups=[0, 1, 0, 1][:len(tg)], n_groups=2)
        xs = [g.astype(jnp.float32) / (1.0 if scale is None
                                       else jnp.float32(scale)) for g in jg]
        sums = [jnp.sum(jnp.square(x)) for x in xs]
        bad = [bool(~jnp.all(jnp.isfinite(x))) for x in xs]
        np.testing.assert_allclose(st.sums.numpy(), np.asarray(sums),
                                   rtol=1e-6)
        assert st.nonfinite.tolist() == [int(b) for b in bad]
        assert int(st.any_nonfinite) == int(any(bad))
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        gn = jnp.sqrt(total)
        factor = jnp.minimum(1.0, 1.5 / jnp.maximum(gn, 1e-12))
        np.testing.assert_allclose(float(st.factor), float(factor), rtol=1e-6)
        np.testing.assert_allclose(st.group_sums.numpy(), [
            float(sum(sums[i] for i in range(len(xs)) if i % 2 == g))
            for g in (0, 1)], rtol=1e-6)
    assert torch.isinf(st.sums[1]) and not st.nonfinite[1]


def test_adamw_plain_master_instance_matches_reference_rule():
    rng = np.random.RandomState(6)
    shape = (9, 7)
    p0 = (0.1 * rng.randn(*shape)).astype(np.float32)
    g_raw = (300.0 * rng.randn(*shape)).astype(np.float32)
    scale, factor, lr = 512.0, 0.37, 1e-3
    ref = jopt_mod.Adam(learning_rate=lr, beta2=0.95, epsilon=1e-5,
                        weight_decay=jopt_mod.L2Decay(0.01))
    master = jnp.asarray(p0).astype(jnp.bfloat16).astype(jnp.float32)
    slots = {"moment1": jnp.zeros(shape, jnp.float32),
             "moment2": jnp.zeros(shape, jnp.float32)}
    tp = torch.from_numpy(p0).to(torch.bfloat16)
    tmaster = tp.float()
    tm, tv = torch.zeros(shape), torch.zeros(shape)
    norms = tadamw.UpdateNorms([tp], [0], 1)
    psq, usq = [], []
    for step in (1, 2, 3):
        g = jnp.asarray(g_raw * step).astype(jnp.bfloat16)
        # the reference step's transform: g / scale, clip, cast to master
        gd = ((g / jnp.float32(scale)).astype(jnp.float32)
              * jnp.float32(factor)).astype(jnp.float32)
        gd = ref._apply_regularization(master, gd)
        old_p = master.astype(jnp.bfloat16).astype(jnp.float32)
        master, slots = jax.jit(ref._rule, static_argnums=())(
            master, gd, slots, jnp.float32(lr), jnp.int32(step))
        new_p = master.astype(jnp.bfloat16).astype(jnp.float32)
        psq.append(float(jnp.sum(old_p * old_p)))
        usq.append(float(jnp.sum((new_p - old_p) ** 2)))
        norms.begin()
        tadamw.adamw_update(
            tp, torch.tensor(np.asarray(g.astype(jnp.float32))).to(
                torch.bfloat16), tm, tv, lr, 0.9, 0.95, 1e-5, step,
            master=tmaster, scale=torch.tensor(scale),
            grad_factor=torch.tensor(factor),
            regularization=topt_mod.L2Decay(0.01), norms=norms)
        out = norms.reduce()
        np.testing.assert_allclose(float(out[0, 0]), psq[-1], rtol=1e-6)
        np.testing.assert_allclose(float(out[1, 0]), usq[-1], rtol=1e-6)
    np.testing.assert_allclose(tmaster.numpy(), np.asarray(master),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tm.numpy(), np.asarray(slots["moment1"]),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tv.numpy(), np.asarray(slots["moment2"]),
                               rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(tp, tmaster.to(torch.bfloat16), rtol=0,
                               atol=0)


def test_transform_grad_rounding_points():
    """(g.f32 * factor) lands back in bf16 without a scale and stays f32
    with one (jit_api.py:328-363)."""
    g = torch.tensor([1.0, 3.0, -7.0], dtype=torch.bfloat16)
    f = torch.tensor(0.3)
    assert tadamw.transform_grad(g, None, f).dtype == torch.bfloat16
    scaled = tadamw.transform_grad(g, torch.tensor(4.0), f)
    assert scaled.dtype == torch.float32
    jg = jnp.asarray([1.0, 3.0, -7.0], jnp.bfloat16)
    want = ((jg / jnp.float32(4.0)).astype(jnp.float32)
            * jnp.float32(0.3)).astype(jnp.float32)
    np.testing.assert_array_equal(scaled.numpy(), np.asarray(want))
    want_bf = (jg.astype(jnp.float32) * jnp.float32(0.3)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        tadamw.transform_grad(g, None, f).float().numpy(),
        np.asarray(want_bf.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
def test_decay_term_matches_reference_bit_for_bit(kind, dtype):
    x = np.random.RandomState(4).randn(4096).astype(np.float32)
    x[:3] = 0.0
    want = getattr(jreg, kind)(0.1)(
        jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = getattr(topt_mod, kind)(0.1)(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want._data.astype(jnp.float32)))
