"""Port parity in fp16: the plain versions of the kernels with fp16
instances, the fp16 model, the fp16 training recipe and the fp16 serve
against the JAX package on the CPU (its Pallas functions through their
math tiers, as its own tests run them here).

Tolerances, from fp16's unit roundoff u = 2^-11 (4.9e-4):
- flash attention (K1 MHA, K2 GQA, K3 packed and varlen), forward and
  ``jax.vjp``: atol = rtol = 4e-3. The reference's math tier rounds the
  scores to fp16 before the softmax (paddle_tpu/ops/flash_attention.py
  :379) and the port's plain version does not: a score of size s moves by
  u s (s up to ~4 here), a weight by as much relative, and an output or a
  gradient (a sum of ~40 such terms) by a few u of its largest terms;
  both also round P to fp16 and each output once;
- paged attention (K4 and K5) over fp16 pools, and over int8 pools read by
  an fp16 q: atol = rtol = 2e-3, a few u: both round q * scale to fp16
  (the reference gets it as the port rounds it, with scale 1, since jax
  rounds a Python scale to fp16 first) and the output once, and sum in
  f32 in another order;
- AdamW on fp16 parameters (plain: fp16 moments; with f32 master
  weights), three updates, a block of zero gradients among them: the
  parameters within one fp16 ulp; the moments within two ulps of each
  value plus one ulp of the tensor's largest (the reference's CPU program
  rounds b1 m + (1 - b1) g once where the port rounds each product to
  fp16 first, the rounding points its bf16 rules match bit for bit, so where
  the two terms cancel the sums differ by an ulp of the terms); the
  zero-gradient elements do not move (eps stays f32 in both: 0 / (0 +
  1e-8));
- kernel A's plain version on fp16 gradients: sums 1e-6 relative, flags
  exact (a finite 6e4, whose square overflows fp16, is not flagged);
- ``llama_tiny(dtype="float16")`` logits: atol 2e-3 (4 u at logits below
  1; the two frameworks round the fp16 products at other places), the
  loss 1e-4 relative (f32 cross-entropy of those logits);
- ``TrainStep`` under ``decorate(O2, float16)`` with a ``GradScaler``
  (init 2^15, halved on each bad step), 4 steps, the loss times 2^127 at
  steps 1 and 3: skip pattern and scale sequence equal, finite losses 1e-4
  relative, the master weights f32, each fp16 parameter within 2 lr per
  update of the reference's plus one fp16 ulp (Adam moves an element by
  about lr whatever its gradient's size, so a gradient near zero, summed
  in another order, may move it the other way);
- the engine's greedy serve of an fp16 ``llama_tiny`` (ragged and legacy
  planes, fp16 pools; int8 pools): token ids identical to the JAX
  engine's in its sync pipeline;
- the wrappers take fp16 CPU tensors (their plain versions) and the
  kernels' dtype check takes fp16 and refuses int and f64; kernels C and
  D/E refuse fp16 with a message that names the ROADMAP item.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine, EngineRequest,
)
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import grad_norm as tgn
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.ops.quantization import QuantizedTensor

tF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
F16 = np.float16
FLASH_TOL = dict(atol=4e-3, rtol=4e-3)
PAGED_TOL = dict(atol=2e-3, rtol=2e-3)
OVERFLOW = 2.0 ** 127


def _f16(*arrays):
    return [a.astype(F16) for a in arrays]


def _torch_grads(attn, q, k, v, do):
    t = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = attn(*t)
    out.backward(torch.from_numpy(do))
    return [out.detach().float().numpy()] + [x.grad.float().numpy()
                                             for x in t]


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out, np.float32)] + [
        np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]


def _close(got, want, tol):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


# -- the flash kernels' plain versions: K1, K2, K3 ----------------------------

@pytest.mark.parametrize("hq,hkv,sq,sk,causal", [
    (4, 4, 37, 37, True), (4, 2, 21, 37, False)])
def test_flash_plain_fp16_matches_reference(hq, hkv, sq, sk, causal):
    rng = np.random.RandomState(hq + sq)
    q, k, v, do = _f16(rng.randn(2, sq, hq, 16), rng.randn(2, sk, hkv, 16),
                       rng.randn(2, sk, hkv, 16), rng.randn(2, sq, hq, 16))
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention_fwd(
        a, b, c, causal=causal, scale=0.3), q, k, v, do)
    got = _torch_grads(lambda a, b, c: tfa.flash_attention_fwd(
        a, b, c, causal=causal, scale=0.3), q, k, v, do)
    _close(got, want, FLASH_TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 2)])
def test_packed_and_varlen_fp16_match_reference(hq, hkv):
    rng = np.random.RandomState(hq * hkv)
    seg = np.repeat([[0] * 10 + [1] * 17 + [2] * 10], 2, 0).astype(np.int32)
    q, k, v, do = _f16(*(rng.randn(2, 37, h, 16) for h in (hq, hkv, hkv,
                                                            hq)))
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention_packed(
        a, b, c, jnp.asarray(seg), causal=True, scale=0.3), q, k, v, do)
    got = _torch_grads(lambda a, b, c: tfa.flash_attention_packed(
        a, b, c, torch.from_numpy(seg), causal=True, scale=0.3), q, k, v, do)
    _close(got, want, FLASH_TOL)
    cu = [0, 7, 20, 33]
    q, k, v, do = _f16(*(rng.randn(37, h, 16) for h in (hq, hkv, hkv, hq)))
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention_varlen_fwd(
        a, b, c, jnp.asarray(cu, jnp.int32), jnp.asarray(cu, jnp.int32),
        causal=True, scale=0.3), q, k, v, do)
    got = _torch_grads(lambda a, b, c: tF.flash_attn_unpadded(
        a, b, c, torch.tensor(cu), torch.tensor(cu), None, None, scale=0.3,
        causal=True)[0], q, k, v, do)
    _close(got, want, FLASH_TOL)


# -- the paged kernels' plain versions: K4, K5 --------------------------------

def _pools(rng, pool, hkv, P, bs, d):
    """The same pool on both sides: fp16 rows, or int8 codes quantized by
    the reference from f32 rows."""
    f = rng.randn(hkv, P, bs, d).astype(np.float32)
    if pool == "int8":
        jq = jpa.quantize_pages(jnp.asarray(f))
        return jq, QuantizedTensor(torch.from_numpy(np.array(jq.weight)),
                                   torch.from_numpy(np.array(jq.scales)))
    return jnp.asarray(f.astype(F16)), torch.from_numpy(f.astype(F16))


@pytest.mark.parametrize("pool", ["float16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(8, 2)])
def test_paged_plain_fp16_matches_reference(pool, hq, hkv):
    """K5 and K4 on an fp16 q over fp16 pools and over int8 pools."""
    rng = np.random.RandomState(hq + hkv)
    d, bs, pps, B = 16, 16, 6, 4
    P = 1 + B * pps
    jk, tk = _pools(rng, pool, hkv, P, bs, d)
    jv, tv = _pools(rng, pool, hkv, P, bs, d)
    pt = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    scale = d ** -0.5
    lengths = np.array([1, 16, 17, 90], np.int32)
    q = torch.from_numpy(rng.randn(B, hq, d).astype(F16))
    got = tpa.paged_decode_attention(q, tk, tv, torch.from_numpy(lengths),
                                     torch.from_numpy(pt))
    assert got.dtype == torch.float16
    want = jpa.paged_decode_attention(
        jnp.asarray((q * scale).numpy()), jk, jv, jnp.asarray(lengths),
        jnp.asarray(pt), scale=1.0)
    assert want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **PAGED_TOL)
    q_lens = np.array([1, 0, 30, 2], np.int32)
    kv_lens = np.array([60, 0, 30, 75], np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    qr = torch.from_numpy(rng.randn(int(cu[-1]), hq, d).astype(F16))
    got = trpa.ragged_paged_attention(qr, tk, tv, torch.from_numpy(kv_lens),
                                      torch.from_numpy(pt),
                                      torch.from_numpy(cu))
    want = jrpa.ragged_paged_attention(
        jnp.asarray((qr * scale).numpy()), jk, jv, jnp.asarray(kv_lens),
        jnp.asarray(pt), jnp.asarray(cu), scale=1.0)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **PAGED_TOL)


# -- AdamW and kernel A -------------------------------------------------------

def _ulps(a, b):
    """fp16 values a and b apart in ulps (as ordered integers)."""
    def key(x):
        i = x.astype(F16).view(np.int16).astype(np.int32)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("master", [False, True])
def test_adamw_fp16_matches_reference(master):
    rng = np.random.RandomState(5)
    w = rng.randn(6, 5).astype(np.float32)
    grads = [(rng.randn(6, 5) * 0.3).astype(np.float32) for _ in range(3)]
    for g in grads:
        g[0] = 0.0                       # zero gradients, zero moments
    kw = dict(learning_rate=1e-3, weight_decay=0.01, multi_precision=master)
    opt = jopt.AdamW(**kw)
    jp = {"w": jnp.asarray(w).astype(jnp.float16)}
    state = opt.init_state({"w": paddle.to_tensor(jp["w"])})
    update = jax.jit(lambda p, g, s, lr: opt.apply_gradients(p, g, s, lr))
    tp = torch.from_numpy(w).to(torch.float16)
    to = topt.AdamW(parameters=[("w", tp)], **kw)
    for i, g in enumerate(grads):
        jp, state = update(jp, {"w": jnp.asarray(g).astype(jnp.float16)},
                           state, 1e-3)
        to.apply_gradients([(tp, torch.from_numpy(g).to(torch.float16))])
        assert tp.dtype == torch.float16
        got, want = tp.float().numpy(), np.asarray(jp["w"], np.float32)
        assert _ulps(got, want).max() <= 1, i
        np.testing.assert_array_equal(got[0], w[0].astype(F16))
        slots = to._slots_for(tp)
        for name, ref in state["slots"]["w"].items():
            if not isinstance(slots[name], torch.Tensor):
                assert slots[name] == float(ref), name
                continue
            ref = np.asarray(ref)
            assert str(slots[name].dtype).split(".")[-1] == str(ref.dtype)
            ulp = 2.0 ** -10 if ref.dtype == np.float16 else 2.0 ** -23
            ref = ref.astype(np.float32)
            np.testing.assert_allclose(
                slots[name].float().numpy(), ref, rtol=2 * ulp,
                atol=ulp * float(np.abs(ref).max()), err_msg=name)


def test_grad_sumsq_fp16_matches_jax_math():
    rng = np.random.RandomState(2)
    arrs = [(rng.randn(*s) * 0.3).astype(F16) for s in ((37, 5), (3,), (7,))]
    arrs[1][0] = 6e4          # finite; its square overflows fp16, not f32
    arrs[2][3] = np.inf
    st = tgn.grad_sumsq([torch.from_numpy(a) for a in arrs],
                        scale=torch.tensor(1024.0), clip_norm=1.5)
    xs = [jnp.asarray(a).astype(jnp.float32) / jnp.float32(1024.0)
          for a in arrs]
    sums = [float(jnp.sum(jnp.square(x))) for x in xs]
    np.testing.assert_allclose(st.sums.numpy()[:2], sums[:2], rtol=1e-6)
    assert st.nonfinite.tolist() == [0, 0, 1] and int(st.any_nonfinite) == 1
    assert np.isfinite(float(st.sums[1]))


# -- the model, the recipe, the serve -----------------------------------------

TRAIN_KW = dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                use_recompute=True, recompute_policy="full")


def _fp16_pair(seed, **kw):
    """The reference's llama_tiny cast to fp16 by decorate (O2), and the
    port's built in fp16 from its arrays."""
    paddle.seed(seed)
    jm = jamp.decorate(JaxLlama(jax_tiny(**kw)), level="O2",
                       dtype="float16")
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    assert {a.dtype for a in arrays.values()} == {np.dtype(F16)}
    tm = load_paddle_tpu_state(
        LlamaForCausalLM(llama_tiny(dtype="float16", **kw), device="cpu"),
        arrays)
    return jm, tm, arrays


@pytest.fixture(scope="module")
def tiny16():
    return _fp16_pair(3, num_hidden_layers=1, **TRAIN_KW)


def test_config_and_weights_carry_fp16(tiny16):
    assert LlamaConfig(dtype="float16").dtype == "float16"
    with pytest.raises(ValueError, match="dtype"):
        LlamaConfig(dtype="float64")
    _, tm, arrays = tiny16
    assert {p.dtype for p in tm.parameters()} == {torch.float16}
    back = export_paddle_tpu_state(tm)
    for name, a in arrays.items():      # f32 holds every fp16 exactly
        np.testing.assert_array_equal(back[name].astype(F16).view(np.int16),
                                      a.view(np.int16), err_msg=name)


def test_host_copies_keep_fp16(tiny16):
    """The Predictor's outputs and the engine's exported K/V rows stay fp16
    on the host (numpy has fp16; only bf16 widens to f32)."""
    from paddle_tpu_torch.inference import create_predictor
    from paddle_tpu_torch.inference.predictor import _to_numpy

    assert _to_numpy(torch.zeros(2, dtype=torch.float16)).dtype == F16
    assert _to_numpy(torch.zeros(2, dtype=torch.bfloat16)).dtype == (
        np.float32)
    _, tm, _ = tiny16
    ids = np.random.RandomState(1).randint(0, 128, (1, 9)).astype(np.int32)
    tm.config.fuse_linear_cross_entropy = False
    out = create_predictor(tm, device="cpu").run([ids])[0]
    assert out.dtype == F16
    eng = ContinuousBatchingEngine(tm, async_decode=False, device="cpu",
                                   **ENGINE)
    req = EngineRequest(0, ids[0], 6)
    assert eng.try_admit_one(req) == "admitted"
    while req.n_generated == 0:
        eng.step()
    pay = eng.export_pages(req.slot)
    assert pay["ks"].dtype == F16 and pay["vs"].dtype == F16


def test_llama_fp16_logits_and_loss_match_reference(tiny16):
    jm, tm, _ = tiny16
    ids = np.random.RandomState(0).randint(0, 128, (2, 25))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)
    jm.config.fuse_linear_cross_entropy = False
    tm.config.fuse_linear_cross_entropy = False
    jout = jm(paddle.to_tensor(x))
    jl = np.asarray(jout._data)
    with torch.no_grad():
        tout = tm(torch.from_numpy(x))
    tl = tout
    assert jl.dtype == F16 and tl.dtype == torch.float16
    np.testing.assert_allclose(tl.float().numpy(), jl.astype(np.float32),
                               atol=2e-3, rtol=0)
    jloss = float(np.asarray(JaxCrit()(jout, paddle.to_tensor(y))._data))
    tloss = float(LlamaPretrainingCriterion()(tout, torch.from_numpy(y)))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


def test_train_step_fp16_o2_with_scaler_matches_reference():
    jm, tm, _ = _fp16_pair(31, num_hidden_layers=1, **TRAIN_KW)
    kw = dict(learning_rate=1e-3, weight_decay=0.01)
    jm, jo = jamp.decorate(jm, jopt.AdamW(parameters=jm.parameters(), **kw),
                           level="O2", dtype="float16")
    tm, to = tamp.decorate(tm, topt.AdamW(parameters=tm.named_parameters(),
                                          **kw), level="O2", dtype="float16")
    scaler = dict(decr_every_n_nan_or_inf=1)   # init_loss_scaling 2^15
    jstep = JaxTrainStep(
        jm, lambda h, w, y, m: (JaxCrit()(h, w, y) * m).sum(), jo,
        n_labels=2, scaler=jamp.GradScaler(**scaler))
    tstep = TrainStep(
        tm, lambda h, w, y, m: LlamaPretrainingCriterion()(h, w, y)
        * m.reshape(()), to, n_labels=2, scaler=tamp.GradScaler(**scaler),
        device="cpu")
    scales, updates = [], 0
    for i in range(4):
        ids = np.random.RandomState(40 + i).randint(0, 128, (2, 25))
        b = (ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64),
             np.array([OVERFLOW if i in (0, 2) else 1.0], np.float32))
        jl = float(np.asarray(jstep(*[paddle.to_tensor(a) for a in b])._data))
        tl = float(tstep(*b))
        skipped = int(jstep.opt_state["step"]) == updates
        updates = int(jstep.opt_state["step"])
        assert tstep.last_skipped == skipped == (i in (0, 2)), i
        scale = float(tstep._scaler_state["scale"])
        assert scale == float(jstep._scaler_state["scale"]), i
        scales.append(scale)
        if skipped:
            assert not np.isfinite(tl) and not np.isfinite(jl)
        else:
            np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"{i}")
    assert scales == [2.0 ** 14, 2.0 ** 14, 2.0 ** 13, 2.0 ** 13]
    assert updates == to._global_step == 2
    masters = [s["master_weight"] for s in to._accumulators.values()]
    assert masters and all(m.dtype == torch.float32 for m in masters)
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        want = np.asarray(p._data).astype(np.float32)
        assert p._data.dtype == jnp.float16
        limit = 2 * 1e-3 * updates + np.abs(want) * 2.0 ** -10
        assert (np.abs(got[name] - want) <= limit).all(), name


ENGINE = dict(max_seqs=4, page_size=16, max_len=256, decode_block=4)
NEW = 8


@pytest.fixture(scope="module")
def serve_models():
    jm, tm, _ = _fp16_pair(41, num_hidden_layers=2,
                           max_position_embeddings=256)
    jm.eval()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (9, 70, 30)]
    return jm, tm, prompts


@pytest.mark.parametrize("plane", ["ragged", "legacy", "int8"])
def test_engine_fp16_greedy_tokens_identical(serve_models, plane):
    jm, tm, prompts = serve_models
    kw = dict(ENGINE)
    if plane == "legacy":
        kw["ragged"] = False
    if plane == "int8":
        kw["kv_cache_dtype"] = "int8"
    want = JaxEngine(jm, async_decode=False, **kw).serve(prompts, NEW)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    pools = eng.pools[0][0]
    assert (pools.weight.dtype == torch.int8 if plane == "int8"
            else pools.dtype == torch.float16)
    got = eng.serve(prompts, NEW)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# -- the wrappers' dtypes -----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.int8])
def test_kernels_take_fp16_and_refuse_int_and_f64(dtype):
    _build.check_dtype("k", torch.zeros(2, dtype=torch.float16))
    assert _build.DTYPE_CODES["torch.float16"] == 2
    with pytest.raises(ValueError, match="not in"):
        _build.check_dtype("k", torch.zeros(2, dtype=dtype))
    for codes in (None, _build.F32_BF16_CODES):
        with pytest.raises(ValueError, match="not in"):
            _build.check_dtype("k", torch.zeros(2, dtype=dtype), codes)
    with pytest.raises(ValueError, match="ROADMAP section 1 item 3"):
        _build.check_dtype("weight_only_linear",
                           torch.zeros(2, dtype=torch.float16),
                           _build.F32_BF16_CODES)


def test_wrappers_take_fp16_cpu_tensors():
    """Every wrapper with an fp16 instance runs its plain version on fp16
    CPU tensors and returns fp16 (finite)."""
    g = torch.Generator().manual_seed(0)

    def rand(*s):
        return torch.randn(*s, generator=g).to(torch.float16)

    q, k, v = rand(1, 20, 4, 16), rand(1, 20, 2, 16), rand(1, 20, 2, 16)
    outs = [tfa.flash_attention_fwd(q, k, v, causal=True),
            tfa.flash_attention_packed(q, k, v, torch.zeros(1, 20,
                                                            dtype=torch.int32))]
    kp, vp = rand(2, 5, 16, 16), rand(2, 5, 16, 16)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    outs.append(tpa.paged_decode_attention(
        rand(2, 4, 16), kp, vp, torch.tensor([5, 20], dtype=torch.int32), pt))
    outs.append(trpa.ragged_paged_attention(
        rand(3, 4, 16), kp, vp, torch.tensor([5, 20], dtype=torch.int32), pt,
        torch.tensor([0, 1, 3], dtype=torch.int32)))
    for o in outs:
        assert o.dtype == torch.float16 and torch.isfinite(o).all()
