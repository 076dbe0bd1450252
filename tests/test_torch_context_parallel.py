"""Port parity: context-parallel training of paddle_tpu_torch against the
JAX reference on the CPU, at ``llama_tiny`` sizes (2 layers).

The reference runs its ``DistributedTrainStep`` (and eager forwards) on
``build_mesh(sep=4)`` over four devices of the 8-device virtual CPU mesh
(tests/conftest.py); the port on ``build_mesh(sep=4, devices=["cpu"] *
4)``, every sep rank in one process. Weights go across with
``load_paddle_tpu_state``; inputs are drawn by numpy from seeds. Tolerances
are ``tests/test_torch_training.py``'s (f32; the two differ in summation
order only), save the capped exemption below:
- loss within rtol 1e-5, every parameter gradient within rtol 1e-4, atol
  1e-6, against the reference's gradients of the same model (ring: MHA,
  GQA 8/2, with recompute; Ulysses: MHA, GQA 8/4 riding the all-to-all
  unexpanded, GQA 8/2 expanded first);
- three ``DistributedTrainStep``s (AdamW lr 1e-3) against the reference's
  on its sep mesh: losses within rtol 1e-5, parameters within atol 3e-5
  (3% of lr), save at most ``EXEMPT_MAX`` elements whose gradient sat
  within 1e-5 of its tensor's largest at some step, where Adam's step is
  set by summation noise (``_record_near_zero_gradients``), and those
  within one lr (1e-3);
- the reference's own oracle (tests/test_context_parallel.py:34-57): the
  loss under the sep mesh equals the loss with no mesh within rtol 2e-5,
  atol 2e-6;
- a [B, S] padding ``attention_mask`` with no mesh: logits (rtol 1e-5,
  atol 1e-5), loss and gradients at the limits above;
- every refusal raises with the reference's words where it has them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.fleet.meta_parallel.segment_parallel import (
    split_inputs_sequence_dim as jax_split,
)
from paddle_tpu.distributed.train_step import (
    DistributedTrainStep as JaxDistributedTrainStep,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.distributed import (
    AXES, DistributedTrainStep, axis_size, build_mesh, get_mesh, has_mesh,
    mesh_guard, split_inputs_sequence_dim,
)
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.ops import ring_attention as tra
from paddle_tpu_torch.optimizer import AdamW

SEP = 4
# test_cp_train_steps_match_reference: at most this many elements past atol
# 3e-5 for a gradient near zero (ring 1, at 8.7e-5; Ulysses 2, the larger
# 7.0e-4 = 0.70 lr: an embedding row whose one nonzero gradient, 9e-8,
# lies a few of Adam's eps from 0)
EXEMPT_MAX = 4
TRAIN_KW = dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                use_recompute=True, recompute_policy="full")


def _cpu_mesh(sep=SEP):
    return build_mesh(sep=sep, devices=["cpu"] * sep)


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


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


GRAD_CASES = {
    "ring": dict(context_parallel=True),
    "ring-gqa": dict(context_parallel="ring", num_attention_heads=8,
                     num_key_value_heads=2),
    "ring-recompute": dict(context_parallel=True, **TRAIN_KW),
    "ulysses": dict(context_parallel="ulysses"),
    "ulysses-gqa-unexpanded": dict(context_parallel="ulysses",
                                   num_attention_heads=8,
                                   num_key_value_heads=4),
    "ulysses-gqa-expanded": dict(context_parallel="ulysses",
                                 num_attention_heads=8,
                                 num_key_value_heads=2),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_cp_loss_and_gradients_match_reference(case):
    """The port's context-parallel forward and backward against the
    reference's gradients. The reference's eager forward under its sep
    mesh runs op by op through shard_map (half a minute a case, and it
    refuses recompute there), so its gradients come from the same model
    with no mesh, which its own oracle equates with the CP ones; the CP
    losses and updates are held against its compiled
    ``DistributedTrainStep`` below."""
    kw = GRAD_CASES[case]
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    x, y = _batch(3)
    jm.train()
    jloss = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    tm.train()
    with mesh_guard(_cpu_mesh()):
        tloss = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
        tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    linear = _linear_names(tm)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        g = g.T if name in linear else g
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("cp", [True, "ulysses"])
def test_cp_train_steps_match_reference(cp):
    kw = dict(context_parallel=cp, **TRAIN_KW)
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    with JM.mesh_guard(JM.build_mesh(sep=SEP)):
        jstep = JaxDistributedTrainStep(
            jm, lambda *a: JaxCrit()(*a),
            JaxAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                     weight_decay=0.01))
        jl = [float(jstep(*(paddle.to_tensor(b) for b in _batch(10 + i)))
                    .numpy()) for i in range(3)]
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                weight_decay=0.01)
    near_zero = _record_near_zero_gradients(tm, opt)
    tstep = DistributedTrainStep(tm, LlamaPretrainingCriterion(), opt,
                                 mesh=_cpu_mesh())
    tl = [float(tstep(*_batch(10 + i))) for i in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = export_paddle_tpu_state(tm)
    linear = _linear_names(tm)
    exempt = []
    for name, p in jm.named_parameters():
        gap = np.abs(got[name] - np.asarray(p._data))
        off = gap > 3e-5
        explained = near_zero[name].numpy()
        explained = explained.T if name in linear else explained
        assert not (off & ~explained).any(), name
        exempt += gap[off].tolist()
    # a handful of exempted elements, each within one step's lr (1e-3)
    assert len(exempt) <= EXEMPT_MAX and max(exempt, default=0) <= 1e-3


def _record_near_zero_gradients(model, opt):
    """{name: bool mask} of the elements whose gradient, at some step of
    ``opt``, was within 1e-5 of its tensor's largest: there Adam's step,
    lr m / sqrt(v), is set by the gradient's last digits, which the two
    frameworks sum in another order (the ring's visits and merges above
    all), so such an element may sit more than 3e-5 (3% of lr) from the
    reference's, up to one lr; every other element may not."""
    names = {id(p): n for n, p in model.named_parameters()}
    masks = {n: torch.zeros(p.shape, dtype=torch.bool)
             for n, p in model.named_parameters()}
    apply = opt.apply_gradients

    def record(pairs, **kw):
        for p, g in pairs:
            if g is not None:
                masks[names[id(p)]] |= g.abs() <= 1e-5 * g.abs().max()
        return apply(pairs, **kw)

    opt.apply_gradients = record
    return masks


@pytest.mark.parametrize("case", ["ring", "ring-gqa", "ulysses"])
def test_cp_loss_equals_no_mesh_loss(case):
    """The reference's oracle: context parallel is inert without a sep
    mesh, and the loss under the mesh equals that plain loss; both equal
    the reference's no-mesh loss."""
    kw = dict(GRAD_CASES[case])
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    x, y = _batch(7, B=4)
    ref = float(jm(paddle.to_tensor(x), labels=paddle.to_tensor(y)).numpy())
    with torch.no_grad():
        plain = float(tm(torch.from_numpy(x), labels=torch.from_numpy(y)))
        with mesh_guard(_cpu_mesh()):
            cp = float(tm(torch.from_numpy(x), labels=torch.from_numpy(y)))
    np.testing.assert_allclose(cp, plain, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(plain, ref, rtol=1e-5)


def test_cp_step_takes_the_ring_every_layer_forward_and_recompute(
        monkeypatch):
    """The launch count the card holds, on the CPU: a recomputed CP step
    runs one K6 visit per kept visit of the sep-4 ring in every layer's
    forward and again in its recompute (2 x 2 layers x 10), the K1 backward
    entries' plain version once per visit, and never the whole-sequence
    attention."""
    calls = {"visit": 0, "visit_bwd": 0}
    real_fwd, real_bwd = tra.ring_flash_fwd, tra._visit_bwd

    def visit(*a, **k):
        calls["visit"] += 1
        return real_fwd(*a, **k)

    def visit_bwd(*a, **k):
        calls["visit_bwd"] += 1
        return real_bwd(*a, **k)

    def whole(*a, **k):
        raise AssertionError("a CP layer attended over the whole sequence")

    from paddle_tpu_torch.models import llama as tllama

    monkeypatch.setattr(tra, "ring_flash_fwd", visit)
    monkeypatch.setattr(tra, "_visit_bwd", visit_bwd)
    monkeypatch.setattr(tllama, "scaled_dot_product_attention", whole)
    cfg = llama_tiny(num_hidden_layers=2, context_parallel=True, **TRAIN_KW)
    model = LlamaForCausalLM(cfg, device="cpu")
    step = DistributedTrainStep(
        model, LlamaPretrainingCriterion(cfg),
        AdamW(learning_rate=1e-3, parameters=model.parameters()),
        mesh=_cpu_mesh())
    assert torch.isfinite(step(*_batch(4)))
    assert calls == {"visit": 2 * 2 * 10, "visit_bwd": 2 * 10}


MASK_CASES = {
    "plain": dict(),
    "recompute-gqa": dict(TRAIN_KW, num_key_value_heads=2),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_attention_mask_matches_reference(case):
    """A [B, S] padding mask on the causal path with no mesh (the
    reference's additive [B, 1, 1, S] mask on top of causal, :313-318):
    logits, the loss and every gradient against the reference's, within
    this module's limits; and the mask changes the padded row."""
    kw = MASK_CASES[case]
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    x, y = _batch(5)
    mask = np.ones(x.shape, np.int64)
    mask[1, -9:] = 0                  # row 1's last 9 tokens are padding
    jm.eval()
    tm.eval()
    with torch.no_grad():
        tl = tm(torch.from_numpy(x), attention_mask=torch.from_numpy(mask))
        plain = tm(torch.from_numpy(x))
    jl = jm(paddle.to_tensor(x), attention_mask=paddle.to_tensor(mask))
    if isinstance(jl, tuple):
        jl = jl[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(tl[0], plain[0])    # row 0 has no padding
    assert not torch.allclose(tl[1], plain[1])
    jm.train()
    tm.train()
    jloss = jm(paddle.to_tensor(x), attention_mask=paddle.to_tensor(mask),
               labels=paddle.to_tensor(y))
    jloss.backward()
    tloss = tm(torch.from_numpy(x), attention_mask=torch.from_numpy(mask),
               labels=torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(np.asarray(jloss._data)),
                               rtol=1e-5)
    linear = _linear_names(tm)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        g = g.T if name in linear else g
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _refusal_model(**kw):
    return LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                       context_parallel=True, **kw),
                            device="cpu")


def _step(model, mesh=None, **kw):
    return DistributedTrainStep(
        model, LlamaPretrainingCriterion(),
        AdamW(learning_rate=1e-3, parameters=model.parameters()),
        mesh=mesh or _cpu_mesh(), **kw)


def _ids(S=32, B=2):
    return torch.from_numpy(_batch(0, B=B, S=S)[0])


REFUSALS = {
    "model-non-divisible-seq": (
        ValueError, "not\\s+divisible by the sep",
        lambda: _run_in_mesh(lambda: _refusal_model()(_ids(S=30)))),
    "step-non-divisible-seq": (
        ValueError, "not\\s+divisible by the sep",
        lambda: _step(_refusal_model())(*_batch(1, S=30))),
    "padding-mask": (
        ValueError, "causal-only",
        lambda: _run_in_mesh(lambda: _refusal_model()(
            _ids(), attention_mask=torch.ones(2, 32)))),
    "padding-mask-no-mesh": (
        ValueError, "segment_ids and attention_mask are exclusive",
        lambda: _refusal_model()(
            _ids(), attention_mask=torch.ones(2, 32),
            segment_ids=torch.zeros(2, 32, dtype=torch.int32))),
    "padding-mask-cache": (
        ValueError, "packing is a training path",
        lambda: _refusal_model()(
            _ids(), past_key_values=[None], attention_mask=torch.ones(2, 32),
            segment_ids=torch.zeros(2, 32, dtype=torch.int32))),
    "segment-ids": (
        ValueError, "do not compose with context_parallel",
        lambda: _run_in_mesh(lambda: _refusal_model()(
            _ids(), segment_ids=torch.zeros(2, 32, dtype=torch.int32)))),
    "ulysses-heads": (
        ValueError, "divisible by sep=4",
        lambda: _run_in_mesh(lambda: LlamaForCausalLM(llama_tiny(
            num_hidden_layers=1, num_attention_heads=2,
            context_parallel="ulysses"), device="cpu")(_ids()))),
    "config-value": (
        ValueError, "context_parallel must be",
        lambda: llama_tiny(context_parallel="zigzag")),
    "mesh-dp-axis": (
        NotImplementedError, "only the sep axis may exceed 1",
        lambda: build_mesh(dp=2, sep=2, devices=["cpu"] * 4)),
    "mesh-mp-axis": (
        NotImplementedError, "only the sep axis may exceed 1",
        lambda: build_mesh(mp=2, devices=["cpu"] * 2)),
    "mesh-dcn": (
        NotImplementedError, "multi-slice",
        lambda: build_mesh(dcn_dp=2, devices=["cpu"] * 2)),
    "mesh-distinct-devices": (
        NotImplementedError, "distinct devices",
        lambda: build_mesh(sep=2, devices=["cpu", "meta"])),
    "mesh-too-few-devices": (
        ValueError, "need 4 devices, have 2",
        lambda: build_mesh(sep=4, devices=["cpu"] * 2)),
    "step-sharding-stage": (
        NotImplementedError, "sharding_stage",
        lambda: _step(_refusal_model(), sharding_stage=3)),
    "step-batch-axes": (
        NotImplementedError, "batch_axes",
        lambda: _step(_refusal_model(), batch_axes=("dp",))),
    "step-full-state-dict": (
        NotImplementedError, "ROADMAP",
        lambda: _step(_refusal_model()).full_state_dict()),
    "step-snapshots": (
        NotImplementedError, "snapshots",
        lambda: _step(_refusal_model()).attach_snapshot_ring(None)),
}


def _run_in_mesh(fn):
    with mesh_guard(_cpu_mesh()), torch.no_grad():
        return fn()


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cp_refusals(case):
    exc, match, fn = REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn()


def test_mesh_api():
    mesh = _cpu_mesh()
    assert mesh.axis_names == AXES
    assert mesh.shape == dict(dcn_dp=1, dp=1, pp=1, sharding=1, sep=4, mp=1)
    assert mesh.axis_devices("sep") == [torch.device("cpu")] * 4
    assert not has_mesh()
    with mesh_guard(mesh) as m:
        assert m is mesh and get_mesh() is mesh and axis_size("sep") == 4
        assert axis_size("tp") == 1
        with mesh_guard(_cpu_mesh(2)):
            assert axis_size("sep") == 2
        assert axis_size("sep") == 4
    assert not has_mesh()


def test_default_mesh_is_on_the_card(monkeypatch):
    """With no mesh set, ``get_mesh`` builds one over the CUDA devices, as
    every entry point defaults to the card; without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmesh, "_global_mesh", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mesh(sep=4)


def test_split_inputs_sequence_dim_matches_reference():
    x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    got = split_inputs_sequence_dim([torch.from_numpy(x), 5], rank=2,
                                    degree=4)
    want = jax_split([paddle.to_tensor(x), 5], rank=2, degree=4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]._data))
    assert got[1] == 5
    t = torch.from_numpy(x)
    assert split_inputs_sequence_dim(t, degree=4) is t
    with mesh_guard(_cpu_mesh()):
        np.testing.assert_array_equal(
            split_inputs_sequence_dim(t, rank=1).numpy(), x[:, 2:4])
