"""Port parity: the attention ops and the fused functionals of
paddle_tpu_torch against the JAX reference on the CPU.

The torch tier of each op (the plain version a CPU tensor runs) is held
against the JAX math tier it replaces, on inputs drawn with numpy from a
seed. Float outputs agree within atol = rtol = 2e-5 (f32, summation order
only); page writes are bit-identical on every page except scratch page 0,
where pad tokens' duplicate writes collide by design. The rope and SwiGLU
functionals of ``paddle_tpu_torch.incubate.nn.functional`` agree with
``paddle_tpu.incubate.nn.functional`` within 1e-6 (f32 elementwise math).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn import functional as jinc
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.nn import functional as tnnf
from paddle_tpu_torch.incubate.nn import functional as tinc
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

TOL = dict(rtol=2e-5, atol=2e-5)
GROUPS = {"mha": (4, 4), "gqa": (4, 2)}   # (Hq, Hkv)


def _ragged_case(seed, hq, hkv):
    """Row 0 decode over history, row 1 mid-prompt chunk, row 2 fresh
    prefill, row 3 empty; kv_lens not multiples of the page size; two pad
    tokens past cu_q_lens[-1]."""
    rng = np.random.RandomState(seed)
    S, pps, bs, D = 4, 3, 4, 8
    P = 1 + S * pps
    kp = rng.randn(hkv, P, bs, D).astype(np.float32)
    vp = rng.randn(hkv, P, bs, D).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(S, pps).astype(np.int32)
    q_lens = np.array([1, 6, 7, 0], np.int32)
    kv_lens = np.array([9, 11, 7, 0], np.int32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    q = rng.randn(16, hq, D).astype(np.float32)
    return q, kp, vp, kv_lens, pt, cu


def _paged_case(seed, hq, hkv):
    """Four decode rows; row 3 frozen at the scratch page (length 1, page
    table row 0) as the engine parks non-participants."""
    rng = np.random.RandomState(seed)
    B, pps, bs, D = 4, 3, 4, 8
    P = 1 + B * pps
    kp = rng.randn(hkv, P, bs, D).astype(np.float32)
    vp = rng.randn(hkv, P, bs, D).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    pt[3] = 0
    lengths = np.array([5, 12, 1, 1], np.int32)
    q = rng.randn(B, hq, D).astype(np.float32)
    return q, kp, vp, lengths, pt


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("heads", sorted(GROUPS))
def test_ragged_paged_attention_matches_jax_math(heads):
    args = _ragged_case(0, *GROUPS[heads])
    scale = args[0].shape[-1] ** -0.5
    want = np.asarray(jrpa._ragged_math(*_j(*args), scale))
    got = trpa.ragged_paged_attention(*_t(*args))
    # every token, pads included: the plain version repeats the
    # reference's masked arithmetic for them
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("heads", sorted(GROUPS))
def test_paged_decode_attention_matches_jax_math(heads):
    args = _paged_case(1, *GROUPS[heads])
    scale = args[0].shape[-1] ** -0.5
    want = np.asarray(jpa._paged_math(*_j(*args), scale))
    got = tpa.paged_decode_attention(*_t(*args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_tensors_run_the_plain_version_without_launching():
    n4 = trpa.ragged_paged_attention.launches
    n5 = tpa.paged_decode_attention.launches
    trpa.ragged_paged_attention(*_t(*_ragged_case(2, 4, 2)))
    tpa.paged_decode_attention(*_t(*_paged_case(3, 4, 2)))
    assert trpa.ragged_paged_attention.launches == n4
    assert tpa.paged_decode_attention.launches == n5


def test_write_ragged_kv_bit_identical_outside_scratch():
    rng = np.random.RandomState(4)
    S, pps, bs, hkv, D = 3, 3, 4, 2, 8
    P = 1 + S * pps
    pages = rng.randn(hkv, P, bs, D).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(S, pps).astype(np.int32)
    # row 0: positions 2..6 (crosses a page edge); row 2: position 9;
    # three pad tokens -> scratch page 0
    row_of = np.array([0, 0, 0, 0, 0, 2, 0, 0, 0], np.int32)
    token_pos = np.array([2, 3, 4, 5, 6, 9, 0, 0, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 0, 0], bool)
    new = rng.randn(len(row_of), hkv, D).astype(np.float32)
    args = (pt, row_of, token_pos, valid, new)
    want = np.asarray(jrpa.write_ragged_kv(jnp.asarray(pages), *_j(*args)))
    got = trpa.write_ragged_kv(torch.from_numpy(pages.copy()), *_t(*args))
    np.testing.assert_array_equal(got.numpy()[:, 1:], want[:, 1:])
    assert not np.array_equal(want[:, 1:], pages[:, 1:])  # it did write


def test_write_token_kv_bit_identical_outside_scratch():
    rng = np.random.RandomState(5)
    B, pps, bs, hkv, D = 4, 3, 4, 2, 8
    P = 1 + B * pps
    pages = rng.randn(hkv, P, bs, D).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    pt[2:] = 0                                   # two frozen rows collide
    lengths = np.array([3, 8, 0, 0], np.int32)   # page edge at 8 = 2 * bs
    new = rng.randn(B, hkv, D).astype(np.float32)
    args = (pt, lengths, new)
    want = np.asarray(jpa.write_token_kv(jnp.asarray(pages), *_j(*args)))
    got = tpa.write_token_kv(torch.from_numpy(pages.copy()), *_t(*args))
    np.testing.assert_array_equal(got.numpy()[:, 1:], want[:, 1:])
    assert not np.array_equal(want[:, 1:], pages[:, 1:])


# ---- fused functionals ------------------------------------------------------
def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x)


@pytest.mark.parametrize("table", ["none", "2d", "4d"])
@pytest.mark.parametrize("with_pids", [False, True])
def test_fused_rotary_position_embedding_matches_reference(table, with_pids):
    """Rope through the re-exported functional, with no tables (built from
    the base), [S, D] and [1, S, 1, D] tables, with and without
    position_ids, neox style named; q, k and v each rotated."""
    rng = np.random.RandomState(3)
    B, S, H, D = 2, 7, 3, 8
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    kw = dict(use_neox_rotary_style=True, rotary_emb_base=500.0)
    if table != "none":
        ang = rng.rand(S + 3, D).astype(np.float32) * 3
        cos, sin = np.cos(ang), np.sin(ang)
        if table == "4d":
            cos, sin = cos[None, :, None, :], sin[None, :, None, :]
            if not with_pids:
                cos, sin = cos[:, :S], sin[:, :S]
        elif not with_pids:
            cos, sin = cos[:S], sin[:S]
        kw.update(cos=cos, sin=sin)
    if with_pids:
        kw["position_ids"] = rng.randint(0, S, (B, S)).astype(np.int64)
    want = jinc.fused_rotary_position_embedding(
        *_j(q, k, v), **{n: jnp.asarray(a) if isinstance(a, np.ndarray)
                         else a for n, a in kw.items()})
    got = tinc.fused_rotary_position_embedding(
        *_t(q, k, v), **{n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a for n, a in kw.items()})
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("halves", [True, False])
def test_swiglu_matches_reference(halves):
    """SwiGLU with one argument (split in halves) and with two; ``name``
    accepted as the reference accepts it."""
    rng = np.random.RandomState(4)
    x, y = (rng.randn(3, 5, 16).astype(np.float32) for _ in range(2))
    if halves:
        want = jinc.swiglu(jnp.asarray(x), name="g")
        got = tinc.swiglu(torch.from_numpy(x), name="g")
    else:
        want = jinc.swiglu(jnp.asarray(x), jnp.asarray(y))
        got = tinc.swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


def test_nn_functional_delegates_to_incubate():
    """One implementation: ``nn.functional``'s names are the incubate
    module's functions."""
    for name in ("rope_rotate", "fused_rotary_position_embedding", "swiglu"):
        assert getattr(tnnf, name) is getattr(tinc, name)
