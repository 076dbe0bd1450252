"""Port parity: the int8 KV pool of paddle_tpu_torch against the JAX
reference on the CPU.

- the codec (``ops/quantization.py``) against jax's Pallas paged-attention
  ``quantize_to_int8`` / ``from_int8``: codes, scales and dequantized
  values bit-identical, on seeded rows plus an all-zero row, rows whose
  absmax is +max and -max (codes 127 and -128) and rows on .5 ties;
- the int8 page writes (``write_token_kv``, ``write_ragged_kv``): codes
  and scales bit-identical after the same writes (the ragged write on
  every page but scratch page 0, where pad tokens collide by design);
- the plain versions of K5-int8 and K4-int8 against the reference's
  ``_paged_math`` / ``_ragged_math`` and the interpret-mode Pallas kernel
  ``_ragged_pallas`` on the same int8 pools: f32, atol = rtol = 1e-5
  (summation order only; the dequantized values are bit-identical).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.paged_attention import (
    quantization_utils as jqu,
)

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.ops.quantization import (
    QuantizedTensor, from_int8, is_quantized, quantize_pages,
    quantize_to_int8,
)

TOL = dict(rtol=1e-5, atol=1e-5)
GROUPS = {"mha": (4, 4), "gqa": (4, 2)}   # (Hq, Hkv)


def _codec_rows(seed, d=128):
    rng = np.random.RandomState(seed)
    x = (rng.randn(512, d) * rng.lognormal(0.0, 2.0, (512, 1))
         ).astype(np.float32)
    x[0] = 0.0                          # all zero: scale 0, codes 0
    x[1] = 0.0
    x[1, :3] = (1.0, -1.0, 0.5)         # codes 127, -128, 64
    x[2] = np.abs(x[2])                 # absmax is +max
    x[3] = -np.abs(x[3])                # absmax is -max
    x[4] = np.arange(d, dtype=np.float32) - d / 2 + 0.5   # .5 ties ...
    x[4, 0] = 127.5                     # ... at scale factor 1
    x[5] = -x[4]
    return x


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_codec_bit_identical_to_jax():
    x = _codec_rows(0)
    want = jqu.quantize_to_int8(jnp.asarray(x))
    got = quantize_to_int8(torch.from_numpy(x))
    assert got.weight.dtype == torch.int8
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    np.testing.assert_array_equal(_bits(got.scales.numpy()),
                                  _bits(want.scales))
    assert got.weight[1, :3].tolist() == [127, -128, 64]
    assert not got.weight[0].any() and float(got.scales[0]) == 0.0
    # the tie rows really sit on ties: k + 0.5 after scaling
    assert got.weight[4, 1].item() == -62 and got.weight[4, 2].item() == -62
    deq_want = jqu.from_int8(want.weight, want.scales, jnp.float32)
    deq_got = from_int8(got.weight, got.scales)
    np.testing.assert_array_equal(_bits(deq_got.numpy()), _bits(deq_want))


def test_quantize_pages_matches_reference():
    rng = np.random.RandomState(1)
    pages = rng.randn(2, 5, 4, 8).astype(np.float32)
    want = jpa.quantize_pages(jnp.asarray(pages))
    got = quantize_pages(torch.from_numpy(pages))
    assert is_quantized(got) and not is_quantized(torch.zeros(1))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    np.testing.assert_array_equal(_bits(got.scales.numpy()),
                                  _bits(want.scales))


def _int8_pools(rng, hkv, P, bs, D):
    """The same int8 pool on both sides: quantized seeded f32 rows."""
    f = rng.randn(hkv, P, bs, D).astype(np.float32)
    jq = jpa.quantize_pages(jnp.asarray(f))
    tq = QuantizedTensor(torch.from_numpy(np.array(jq.weight)),
                         torch.from_numpy(np.array(jq.scales)))
    return jq, tq


def test_write_token_kv_int8_bit_identical_outside_scratch():
    rng = np.random.RandomState(5)
    B, pps, bs, hkv, D = 4, 3, 4, 2, 8
    P = 1 + B * pps
    jq, tq = _int8_pools(rng, hkv, P, bs, D)
    pt = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    pt[2:] = 0                                   # two frozen rows collide
    lengths = np.array([3, 8, 0, 0], np.int32)   # page edge at 8 = 2 * bs
    new = rng.randn(B, hkv, D).astype(np.float32)
    new[1, 0] = 0.0                              # an all-zero row
    want = jpa.write_token_kv(jq, jnp.asarray(pt), jnp.asarray(lengths),
                              jnp.asarray(new))
    got = tpa.write_token_kv(tq, torch.from_numpy(pt),
                             torch.from_numpy(lengths), torch.from_numpy(new))
    assert got is tq    # in place
    np.testing.assert_array_equal(got.weight.numpy()[:, 1:],
                                  np.asarray(want.weight)[:, 1:])
    np.testing.assert_array_equal(_bits(got.scales.numpy()[:, 1:]),
                                  _bits(np.asarray(want.scales)[:, 1:]))
    assert not np.array_equal(np.asarray(want.weight), np.asarray(jq.weight))


def test_write_ragged_kv_int8_bit_identical_outside_scratch():
    rng = np.random.RandomState(4)
    S, pps, bs, hkv, D = 3, 3, 4, 2, 8
    P = 1 + S * pps
    jq, tq = _int8_pools(rng, hkv, P, bs, D)
    pt = rng.permutation(np.arange(1, P)).reshape(S, pps).astype(np.int32)
    # row 0: positions 2..6 (crosses a page edge); row 2: position 9;
    # three pad tokens -> scratch page 0
    row_of = np.array([0, 0, 0, 0, 0, 2, 0, 0, 0], np.int32)
    token_pos = np.array([2, 3, 4, 5, 6, 9, 0, 0, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 0, 0], bool)
    new = rng.randn(len(row_of), hkv, D).astype(np.float32)
    args = (pt, row_of, token_pos, valid, new)
    want = jrpa.write_ragged_kv(jq, *[jnp.asarray(a) for a in args])
    got = trpa.write_ragged_kv(tq, *[torch.from_numpy(a.copy())
                                     for a in args])
    np.testing.assert_array_equal(got.weight.numpy()[:, 1:],
                                  np.asarray(want.weight)[:, 1:])
    np.testing.assert_array_equal(_bits(got.scales.numpy()[:, 1:]),
                                  _bits(np.asarray(want.scales)[:, 1:]))
    assert not np.array_equal(np.asarray(want.weight), np.asarray(jq.weight))


@pytest.mark.parametrize("heads", sorted(GROUPS))
def test_paged_decode_int8_matches_jax_math(heads):
    """Four decode rows, lengths ending mid-page; row 3 frozen at the
    scratch page (length 1, page-table row 0)."""
    hq, hkv = GROUPS[heads]
    rng = np.random.RandomState(11)
    B, pps, bs, D = 4, 3, 4, 8
    P = 1 + B * pps
    jq_k, tq_k = _int8_pools(rng, hkv, P, bs, D)
    jq_v, tq_v = _int8_pools(rng, hkv, P, bs, D)
    pt = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    pt[3] = 0
    lengths = np.array([5, 11, 2, 1], np.int32)
    q = rng.randn(B, hq, D).astype(np.float32)
    scale = D ** -0.5
    want = jpa._paged_math(jnp.asarray(q), jq_k, jq_v, jnp.asarray(lengths),
                           jnp.asarray(pt), scale)
    n = tpa.paged_decode_attention.launches_int8
    got = tpa.paged_decode_attention(torch.from_numpy(q), tq_k, tq_v,
                                     torch.from_numpy(lengths),
                                     torch.from_numpy(pt))
    assert tpa.paged_decode_attention.launches_int8 == n   # the plain tier
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mixed_case_int8(seed, hq, hkv):
    """The reference test's mixed batch (row 0 decode, row 1 mid-prompt
    chunk, row 2 fresh prefill, row 3 empty, 2 pad tokens) over int8
    pools."""
    rng = np.random.RandomState(seed)
    S, pps, bs, D = 4, 3, 4, 8
    P = 1 + S * pps
    jq_k, tq_k = _int8_pools(rng, hkv, P, bs, D)
    jq_v, tq_v = _int8_pools(rng, hkv, P, bs, D)
    pt = np.arange(1, P).reshape(S, pps).astype(np.int32)
    q_lens = np.array([1, 6, 7, 0], np.int32)
    kv_lens = np.array([9, 11, 7, 0], np.int32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    q = rng.randn(16, hq, D).astype(np.float32)
    jargs = (jnp.asarray(q), jq_k, jq_v, jnp.asarray(kv_lens),
             jnp.asarray(pt), jnp.asarray(cu))
    targs = (torch.from_numpy(q), tq_k, tq_v, torch.from_numpy(kv_lens),
             torch.from_numpy(pt), torch.from_numpy(cu))
    return jargs, targs, int(cu[-1])


@pytest.mark.parametrize("heads", sorted(GROUPS))
def test_ragged_int8_matches_jax_math_and_pallas(heads):
    jargs, targs, n_valid = _mixed_case_int8(5, *GROUPS[heads])
    scale = 8 ** -0.5
    math = np.asarray(jrpa._ragged_math(*jargs, scale))
    pallas = np.asarray(jrpa._ragged_pallas(*jargs, scale, interpret=True))
    n = trpa.ragged_paged_attention.launches_int8
    got = trpa.ragged_paged_attention(*targs).numpy()
    assert trpa.ragged_paged_attention.launches_int8 == n   # plain tier
    np.testing.assert_allclose(got, math, **TOL)   # pads included
    np.testing.assert_allclose(got[:n_valid], pallas[:n_valid], **TOL)
