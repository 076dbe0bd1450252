"""Port parity: SFT packing (K3, segment-masked attention) of
paddle_tpu_torch against the JAX reference on the CPU, at ``llama_tiny``
sizes, with inputs and weights drawn by numpy from seeds and fed to both
packages. The reference runs its dense branches here (``_on_tpu()`` is
false): ``flash_attention_packed``'s same-segment ∧ tril mask and
``_dense_varlen``.

Tolerances (f32):
- ``varlen_segment_ids`` and ``packed_position_ids``: exact, tokens past
  ``cu[-1]`` and empty sequences included;
- ``flash_attention_packed`` and ``flash_attn_unpadded`` (the plain
  versions on the CPU) against the reference's forward and ``jax.vjp``
  (dq, dk, dv), and the plain backward entries (delta from the stored
  output) against the same ``jax.vjp``: MHA and GQA (Hq 4 / Hkv 2), causal
  and full, lengths that are no multiple of any tile, a cross-offset
  (q and k sequences of different lengths) case and an empty key
  sequence: atol = rtol = 2e-5 (summation order only);
- ``LlamaForCausalLM(segment_ids=...)`` logits against the reference
  model's on the same weights: rtol 1e-4, atol 1e-5 (two layers of
  products summed in another order); the port's packed row against its
  own standalone segments: rtol 2e-4, atol 2e-5, as
  ``tests/test_packed_training.py`` holds the reference;
- 3 packed ``TrainStep``s (recompute off, "full", "dots") against the
  reference's ``TrainStep`` on the same wrapper module: losses within rtol
  1e-5, every parameter within atol 3e-5, as ``test_torch_training.py``;
- ``SegmentFlashAttention.apply`` on a CPU tensor equals the plain
  version's autograd bit for bit, and so do the ``PackedSegments`` that
  ``pack_segments`` prepares once against the raw ids;
- K3's tile-range tables cover every visible pair (any ids), and are tight
  for packed rows;
- the packed path refuses a decode cache.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.jit_api import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.paged_attention import PagedLayerCache
from paddle_tpu_torch.optimizer import AdamW

# the modules (each package's ``flash_attention`` attribute is the function)
JF = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
tF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
TOL = dict(rtol=2e-5, atol=2e-5)


def _seg_ids(lengths):
    """Contiguous ascending ids for a row of the given segment lengths."""
    return np.concatenate([np.full(n, i) for i, n in enumerate(lengths)
                           ]).astype(np.int32)


# -- ids and positions -------------------------------------------------------

@pytest.mark.parametrize("cu,total", [([0, 3, 5], 6), ([0, 3, 3, 5], 7),
                                      ([0, 0, 4, 9], 9), ([0, 7], 12)])
def test_varlen_segment_ids_match_reference(cu, total):
    want = np.asarray(jfa.varlen_segment_ids(jnp.asarray(cu, jnp.int32),
                                             total))
    got = tfa.varlen_segment_ids(torch.tensor(cu), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_position_ids_match_reference():
    seg = np.stack([_seg_ids([3, 2, 3]), _seg_ids([1, 6, 1])])
    want = np.asarray(jfa.packed_position_ids(seg))
    got = tfa.packed_position_ids(torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), [0, 1, 2, 0, 1, 0, 1, 2])


# -- the plain versions against the reference ----------------------------------

# name: (Hq, Hkv, causal); rows of segment lengths summing to S = 37
PACKED_HEADS = {"mha-causal": (4, 4, True), "mha-full": (4, 4, False),
                "gqa-causal": (4, 2, True), "gqa-full": (4, 2, False)}
PACKED_ROWS = ([5, 13, 19], [2, 30, 4, 1])
# name: (cu_q, cu_k, total_q, total_k): self-attention with padding past
# cu[-1]; cross-offset (each sequence's q and k lengths differ); an empty
# key sequence
VARLEN = {"self-padded": ([0, 7, 20, 33], [0, 7, 20, 33], 37, 37),
          "cross-offset": ([0, 5, 12, 20], [0, 9, 11, 25], 20, 25),
          "empty-key": ([0, 6, 14, 21], [0, 8, 8, 19], 21, 19)}


def _packed_inputs(seed, hq, hkv, B=2, S=37, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, hq, D).astype(np.float32)
    k = rng.randn(B, S, hkv, D).astype(np.float32)
    v = rng.randn(B, S, hkv, D).astype(np.float32)
    do = rng.randn(B, S, hq, D).astype(np.float32)
    seg = np.stack([_seg_ids(r) for r in PACKED_ROWS])
    return q, k, v, do, seg


def _varlen_inputs(seed, hq, hkv, tq, tk, D=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(tq, hq, D).astype(np.float32),
            rng.randn(tk, hkv, D).astype(np.float32),
            rng.randn(tk, hkv, D).astype(np.float32),
            rng.randn(tq, hq, D).astype(np.float32))


def _torch_grads(attn, q, k, v, do):
    t = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = attn(*t)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [x.grad.numpy() for x in t]


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", sorted(PACKED_HEADS))
def test_packed_matches_reference_forward_and_vjp(case):
    hq, hkv, causal = PACKED_HEADS[case]
    q, k, v, do, seg = _packed_inputs(31, hq, hkv)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention_packed(
        a, b, c, jnp.asarray(seg), causal=causal, scale=0.3), q, k, v, do)
    got = _torch_grads(lambda a, b, c: tfa.flash_attention_packed(
        a, b, c, torch.from_numpy(seg), causal=causal, scale=0.3),
        q, k, v, do)
    _close(got, want)


def _varlen_case(case, hq, hkv, seed):
    cu_q, cu_k, tq, tk = VARLEN[case]
    return (cu_q, cu_k) + _varlen_inputs(seed, hq, hkv, tq, tk)


@pytest.mark.parametrize("heads", ["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(VARLEN))
def test_varlen_matches_reference_forward_and_vjp(case, causal, heads):
    hq, hkv = (4, 4) if heads == "mha" else (4, 2)
    cu_q, cu_k, q, k, v, do = _varlen_case(case, hq, hkv, 32)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention_varlen_fwd(
        a, b, c, jnp.asarray(cu_q, jnp.int32), jnp.asarray(cu_k, jnp.int32),
        causal=causal, scale=0.3), q, k, v, do)
    got = _torch_grads(lambda a, b, c: tF.flash_attn_unpadded(
        a, b, c, torch.tensor(cu_q), torch.tensor(cu_k), None, None,
        scale=0.3, causal=causal)[0], q, k, v, do)
    _close(got, want)
    if case == "empty-key":   # the sequence with no key comes out 0
        assert not got[0][cu_q[1]:cu_q[2]].any()


def test_flash_attn_unpadded_matches_reference_functional():
    cu_q, cu_k, q, k, v, _ = _varlen_case("cross-offset", 4, 2, 33)
    want, none = JF.flash_attn_unpadded(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        paddle.to_tensor(np.asarray(cu_q, np.int32)),
        paddle.to_tensor(np.asarray(cu_k, np.int32)), 9, 14, causal=True)
    got, softmax = tF.flash_attn_unpadded(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(cu_q),
        torch.tensor(cu_k), 9, 14, causal=True)
    assert softmax is None and none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)
    with tF.sdp_kernel(enable_flash=False):
        plain, _ = tF.flash_attn_unpadded(
            *(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(cu_q),
            torch.tensor(cu_k), 9, 14, causal=True)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


BWD_CASES = ([("packed", c) for c in sorted(PACKED_HEADS)]
             + [("varlen", c) for c in sorted(VARLEN)])


@pytest.mark.parametrize("form,case", BWD_CASES)
def test_plain_backward_matches_reference_vjp(form, case):
    if form == "packed":
        hq, hkv, causal = PACKED_HEADS[case]
        q, k, v, do, seg = _packed_inputs(34, hq, hkv)
        segs = tfa._packed_segments(torch.from_numpy(seg))

        def ref(a, b, c):
            return jfa.flash_attention_packed(a, b, c, jnp.asarray(seg),
                                              causal=causal, scale=0.3)
        batch = (lambda x: x)
    else:
        causal = True
        cu_q, cu_k, q, k, v, do = _varlen_case(case, 4, 2, 35)
        segs = tfa._varlen_segments(cu_q, cu_k, len(q), len(k), "cpu")

        def ref(a, b, c):
            return jfa.flash_attention_varlen_fwd(
                a, b, c, jnp.asarray(cu_q, jnp.int32),
                jnp.asarray(cu_k, jnp.int32), causal=True, scale=0.3)
        batch = (lambda x: x[None])
    want = _jax_vjp(ref, q, k, v, do)
    got = tfa._segment_bwd_math(
        *(batch(torch.from_numpy(a)) for a in (q, k, v)),
        batch(torch.tensor(want[0])), batch(torch.from_numpy(do)), segs,
        causal, 0.3)
    _close([want[0]] + [g.reshape(w.shape).numpy()
                        for g, w in zip(got, want[1:])], want)


@pytest.mark.parametrize("case", ["mha-causal", "gqa-full"])
def test_function_on_cpu_is_the_plain_autograd(case):
    hq, hkv, causal = PACKED_HEADS[case]
    q, k, v, do, seg = _packed_inputs(36, hq, hkv)
    segs = tfa._packed_segments(torch.from_numpy(seg))
    ranges = tfa._tile_ranges(segs, causal)
    got = _torch_grads(lambda a, b, c: tfa.SegmentFlashAttention.apply(
        a, b, c, *segs, *ranges, causal, 0.25), q, k, v, do)
    want = _torch_grads(lambda a, b, c: tfa._segment_math(
        a, b, c, segs, causal, 0.25), q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_prepared_packed_segments_give_the_same_result(causal):
    q, k, v, do, seg = _packed_inputs(38, 4, 2)
    ids = torch.from_numpy(seg)
    packed = tfa.pack_segments(ids)
    np.testing.assert_array_equal(packed.position_ids.numpy(),
                                  tfa.packed_position_ids(ids).numpy())
    for got, want in zip(tfa._tile_ranges(packed.segs, True), packed[1:3]):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    got = _torch_grads(lambda a, b, c: tfa.flash_attention_packed(
        a, b, c, packed, causal=causal), q, k, v, do)
    want = _torch_grads(lambda a, b, c: tfa.flash_attention_packed(
        a, b, c, ids, causal=causal), q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_default_scale_is_inverse_sqrt_head_dim():
    q, k, v, _, seg = _packed_inputs(37, 4, 2)
    want = jfa.flash_attention_packed(*(jnp.asarray(a) for a in (q, k, v)),
                                      jnp.asarray(seg))
    got = tfa.flash_attention_packed(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- K3's tile-range tables --------------------------------------------------

def _tile_pairs(segs, causal, tile=64, key_tile=None):
    """Per batch row, the set of (query tile, key tile) holding a visible
    pair, by brute force (key tiles of ``key_tile`` tokens, default
    ``tile``)."""
    m = segs.mask(causal)
    kt = key_tile or tile
    nq, nk = -(-m.shape[1] // tile), -(-m.shape[2] // kt)
    return [{(i, j) for i in range(nq) for j in range(nk)
             if bool(m[b, i * tile:(i + 1) * tile,
                       j * kt:(j + 1) * kt].any())}
            for b in range(m.shape[0])]


def _visited(ranges):
    return [{(t, o) for t in range(len(r)) for o in range(*r[t].tolist())}
            for r in ranges]


def _sft_rows(seed, B=2, S=1000, lo=30, hi=400):
    """Rows packed greedily from seeded lengths, the tail a segment of its
    own."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(B):
        lens = []
        while sum(lens) < S:
            lens.append(min(int(rng.randint(lo, hi + 1)), S - sum(lens)))
        rows.append(_seg_ids(lens))
    return np.stack(rows)


LAYOUTS = {
    "packed": lambda: tfa._packed_segments(torch.from_numpy(_sft_rows(40))),
    "packed-unsorted-ids": lambda: tfa._packed_segments(torch.from_numpy(
        np.random.RandomState(41).randint(0, 4, (2, 300)).astype(np.int32))),
    "varlen-cross-offset": lambda: tfa._varlen_segments(
        [0, 100, 300, 301, 700], [0, 150, 150, 200, 650], 733, 700, "cpu"),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tile_ranges_cover_every_visible_pair(layout, causal):
    segs = LAYOUTS[layout]()
    key_ranges, query_ranges = tfa._tile_ranges(segs, causal)
    need = _tile_pairs(segs, causal)
    for b, (by_q, by_k) in enumerate(zip(_visited(key_ranges),
                                         _visited(query_ranges))):
        assert need[b] <= by_q
        assert need[b] <= {(i, j) for j, i in by_k}
        if layout == "packed":   # contiguous segments: nothing extra
            assert by_q == need[b]
            assert {(i, j) for j, i in by_k} == need[b]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_forward_key_ranges_cover_every_visible_pair(layout, causal):
    """The bf16 forward's table (128-row query tiles over 128-key tiles),
    converted from the 64-unit table the backward kernels read, covers
    every (query tile, key tile) holding a visible pair, and equals the
    table built directly at tile 128."""
    segs = LAYOUTS[layout]()
    key_ranges, _ = tfa._tile_ranges(segs, causal)
    fwd = tfa._fwd_key_ranges(key_ranges)
    direct, _ = tfa._tile_ranges(segs, causal, tile=128)
    assert fwd.dtype == torch.int32
    assert torch.equal(fwd, direct)
    for b, visited in enumerate(_visited(fwd)):
        assert _tile_pairs(segs, causal, tile=128)[b] <= visited


def _random_packing(seed, S=700):
    """Rows of a seeded packing: segment lengths from 1 to 200 (one-token
    segments among them), the tail a segment of its own."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(2):
        lens = []
        while sum(lens) < S:
            n = 1 if rng.rand() < 0.3 else int(rng.randint(2, 201))
            lens.append(min(n, S - sum(lens)))
        rows.append(_seg_ids(lens))
    return tfa._packed_segments(torch.from_numpy(np.stack(rows)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_range_conversions_equal_brute_force(seed, causal):
    """On random packings, the two tables the bf16 kernels convert from
    the 64-unit ones equal a brute-force table from the mask: the forward's
    and dQ's (128-row query tiles over 128-key tiles) and dK/dV's (128-key
    tiles over 64-row query tiles); each row's [lo, hi) is the first and
    last tile holding a visible pair."""
    segs = _random_packing(100 + seed)
    key_ranges, query_ranges = tfa._tile_ranges(segs, causal)
    for got, pairs in ((tfa._fwd_key_ranges(key_ranges),
                        _tile_pairs(segs, causal, tile=128)),
                       (tfa._dkdv_query_ranges(query_ranges),
                        [{(j, i) for i, j in p} for p in _tile_pairs(
                            segs, causal, tile=64, key_tile=128)])):
        assert got.dtype == torch.int32
        for b, need in enumerate(pairs):
            want = np.zeros(tuple(got.shape[1:]), np.int64)
            for own in range(got.shape[1]):
                other = [o for t, o in need if t == own]
                if other:
                    want[own] = (min(other), max(other) + 1)
            np.testing.assert_array_equal(got[b].numpy(), want)


# -- the model ---------------------------------------------------------------

def _jax_model(seed=23, **kw):
    paddle.seed(seed)
    return JaxLlama(jax_tiny(**kw))


def _port_of(jm, **kw):
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return load_paddle_tpu_state(LlamaForCausalLM(llama_tiny(**kw),
                                                  device="cpu"), arrays)


def _packed_rows(seed, vocab=128, B=2, S=24):
    """Seeded tokens in rows of 3-5 segments (ids contiguous, ascending)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (B, S)).astype(np.int32)
    seg = np.stack([_seg_ids(np.diff(np.concatenate(
        [[0], np.sort(rng.choice(np.arange(1, S), n - 1, replace=False)),
         [S]]))) for n in rng.randint(3, 6, B)])
    return ids, seg


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_packed_logits_match_reference(kv_heads):
    jm = _jax_model(num_key_value_heads=kv_heads)
    jm.eval()
    tm = _port_of(jm, num_key_value_heads=kv_heads)
    ids, seg = _packed_rows(50)
    want = jm(paddle.to_tensor(ids), segment_ids=paddle.to_tensor(seg))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_packed_row_matches_standalone_segments(kv_heads):
    model = LlamaForCausalLM(llama_tiny(num_key_value_heads=kv_heads),
                             device="cpu", seed=71)
    ids, seg = _packed_rows(51, B=1)
    with torch.no_grad():
        packed = model(torch.from_numpy(ids),
                       segment_ids=torch.from_numpy(seg))[0]
        for s in np.unique(seg[0]):
            sl = seg[0] == s
            alone = model(torch.from_numpy(ids[:, sl]))[0]
            np.testing.assert_allclose(packed[sl].numpy(), alone.numpy(),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"segment {s}")


class _Packed(nn.Module):
    """``forward(ids, seg)`` -> ``model(ids, segment_ids=seg)``: the batch
    reaches TrainStep's model positionally."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, seg):
        return self.model(ids, segment_ids=seg)


class _JaxPacked(paddle.nn.Layer):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, seg):
        return self.model(ids, segment_ids=seg)


def _sft_labels(ids, seg):
    """Next-token labels, -100 at each segment's last token (no prediction
    across a boundary)."""
    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    last = np.ones_like(seg, bool)
    last[:, :-1] = seg[:, 1:] != seg[:, :-1]
    labels[last] = -100
    return labels


TRAIN_CASES = {
    "no-recompute": dict(fuse_linear_cross_entropy=True, ce_chunk_size=16),
    "recompute-full": dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                           use_recompute=True, recompute_policy="full"),
    "recompute-dots": dict(fuse_linear_cross_entropy=True, ce_chunk_size=16,
                           use_recompute=True, recompute_policy="dots"),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_packed_train_step_matches_reference_for_three_steps(case):
    kw = TRAIN_CASES[case]
    jm = _jax_model(**kw)
    tm = _port_of(jm, **kw)
    jstep = JaxTrainStep(_JaxPacked(jm), lambda *a: JaxCrit()(*a),
                         JaxAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01))
    tstep = TrainStep(_Packed(tm), LlamaPretrainingCriterion(),
                      AdamW(learning_rate=1e-3,
                            parameters=tm.named_parameters(),
                            weight_decay=0.01), device="cpu")
    for i in range(3):
        ids, seg = _packed_rows(60 + i)
        labels = _sft_labels(ids, seg)
        jl = float(jstep(*(paddle.to_tensor(a)
                           for a in (ids, seg, labels))).numpy())
        tl = float(tstep(ids, seg, labels))
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data), rtol=0,
                                   atol=3e-5, err_msg=name)


def test_packed_refuses_a_decode_cache():
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    ids = torch.ones((1, 1), dtype=torch.long)
    seg = torch.zeros((1, 1), dtype=torch.int32)
    cache = PagedLayerCache(torch.zeros(4, 3, 16, 16),
                            torch.zeros(4, 3, 16, 16),
                            torch.ones((1, 2), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))
    h = model.llama.embed_tokens(ids)
    with pytest.raises(ValueError, match="packing is a training path"):
        model.llama.layers[0](h, torch.zeros((1, 1), dtype=torch.long),
                              cache, segment_ids=seg)
    with pytest.raises(ValueError, match="packing is a training path"):
        model(ids, past_key_values=[cache], segment_ids=seg)
