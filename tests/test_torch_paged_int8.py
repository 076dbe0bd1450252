"""Port parity for the int8-pool attention kernels' design, on the CPU.

- the split plan of the split-KV decode kernel (``kv_split_plan``): every
  page of every length 1 .. pages_per_seq * bs lies in exactly one split;
- the split-and-merge, stated here in plain PyTorch the way K5-int8
  computes it (per-split partials with the hoisted scales, scores in base
  2, merged in split order), against the port's ``_paged_math`` and the
  reference's ``paddle_tpu/ops/paged_attention.py::_paged_math`` over the
  same int8 pools, at lengths on page and split edges: f32 1e-5; a bf16 q
  at the card's bf16 tolerance (atol 2e-2, rtol 1e-2: one bf16 rounding of
  the output);
- K4-int8's plain version (``_ragged_math``) on the tile kernel's edges (a
  decode row, an empty row, a fresh prefill of a chunk that is no multiple
  of the 64-pair tile, a chunk starting mid-page, a 2-token prefill, pad
  tokens) against the reference's ``_ragged_math`` and its Pallas kernel
  in interpret mode: 2e-5.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.ops.quantization import QuantizedTensor

BS = 16
LOG2E = 1.4426950408889634
BF16_TOL = dict(atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("pages_per_seq", [1, 7, 8, 9, 24, 128, 129])
@pytest.mark.parametrize("num_kv_heads", [1, 4, 8, 32])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_split_plan_covers_every_page_once(pages_per_seq, num_kv_heads,
                                           sms):
    splits, per = tpa.kv_split_plan(pages_per_seq, num_kv_heads, sms)
    assert splits >= 1 and per >= 1
    assert splits * per >= pages_per_seq > (splits - 1) * per
    for length in range(1, pages_per_seq * BS + 1):
        npages = min(-(-length // BS), pages_per_seq)
        seen = np.zeros(npages, np.int64)
        for s in range(splits):
            seen[s * per:min((s + 1) * per, npages)] += 1
        assert (seen == 1).all(), (length, splits, per)


def test_split_plan_at_the_main_path_shapes():
    """LLaMA-2-7B serving on 132 SMs (pages_per_seq 128): the longest row
    spreads over 8 splits of 16 pages (the floor SPLIT_MIN_PAGES) at MHA
    (32 kv heads, 9 splits of 15 for two waves) and at GQA (8)."""
    assert tpa.SPLIT_MIN_PAGES == 16
    assert tpa.kv_split_plan(128, 32, 132) == (8, 16)
    assert tpa.kv_split_plan(128, 8, 132) == (8, 16)
    assert tpa.kv_split_plan(512, 8, 132) == (32, 16)   # 8k context


def split_merge_math(q, k_pages, v_pages, lengths, page_indices, scale,
                     pages_per_split):
    """K5-int8's arithmetic in plain PyTorch: q * scale rounded to q's
    dtype; per split, base-2 scores (q . codes) * k_scale * log2(e) /
    127.5, the split's max m, sum of weights l and unnormalised o with
    the weights taking v_scale / 127.5; then the splits merged in order.
    An empty split is (-inf, 0, 0)."""
    B, Hq, D = q.shape
    kc, ks = k_pages.weight, k_pages.scales[..., 0]
    vc, vs = v_pages.weight, v_pages.scales[..., 0]
    Hkv, _, bs, _ = kc.shape
    pps = page_indices.shape[1]
    group = Hq // Hkv
    qs = (q * scale).float().reshape(B, Hkv, group, D)
    out = torch.zeros((B, Hkv, group, D), dtype=torch.float32)
    splits = -(-pps // pages_per_split)
    for b in range(B):
        n = int(lengths[b])
        npages = min(-(-n // bs), pps)
        parts = []
        for s in range(splits):
            j0, j1 = s * pages_per_split, min(npages,
                                              (s + 1) * pages_per_split)
            if j0 >= j1:
                parts.append((torch.full((Hkv, group), -math.inf),
                              torch.zeros((Hkv, group)),
                              torch.zeros((Hkv, group, D))))
                continue
            pid = page_indices[b, j0:j1].long()
            keys = (j1 - j0) * bs
            live = (j0 * bs + torch.arange(keys)) < n
            kcode = kc[:, pid].reshape(Hkv, keys, D).float()
            vcode = vc[:, pid].reshape(Hkv, keys, D).float()
            kf = ks[:, pid].reshape(Hkv, keys) * (LOG2E / 127.5)
            vf = vs[:, pid].reshape(Hkv, keys) / 127.5
            sc = torch.einsum("hgd,hkd->hgk", qs[b], kcode) * kf[:, None]
            sc = torch.where(live, sc, -math.inf)
            m = sc.amax(-1)
            p = torch.exp2(sc - m[..., None])
            o = torch.einsum("hgk,hkd->hgd", p * vf[:, None], vcode)
            parts.append((m, p.sum(-1), o))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l_tot = torch.zeros((Hkv, group))
        o_tot = torch.zeros((Hkv, group, D))
        for m, l, o in parts:     # the kernel's order
            f = torch.where(l > 0, torch.exp2(m - mx), 0.0)
            l_tot = l_tot + l * f
            o_tot = o_tot + o * f[..., None]
        out[b] = o_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def _int8_pools(rng, hkv, P, bs, D):
    """The same int8 pool on both sides: quantized seeded f32 rows."""
    f = (rng.randn(hkv, P, bs, D)
         * rng.lognormal(0.0, 1.0, (hkv, P, bs, 1))).astype(np.float32)
    jq = jpa.quantize_pages(jnp.asarray(f))
    tq = QuantizedTensor(torch.from_numpy(np.array(jq.weight)),
                         torch.from_numpy(np.array(jq.scales)))
    return jq, tq


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (8, 2, 128), (8, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_and_merge_matches_plain_and_jax(hq, hkv, d, dtype):
    """Eight rows at page and split edges (pages of 16, 48 pages a row,
    splits of 16 pages: 1, bs, bs + 1, one split, one past it, two splits
    and one past, the whole row), row 0 frozen at the scratch page."""
    rng = np.random.RandomState(hq * 100 + d)
    pps = 48
    B = 8
    P = 1 + B * pps
    jk, tk = _int8_pools(rng, hkv, P, BS, d)
    jv, tv = _int8_pools(rng, hkv, P, BS, d)
    splits, per = tpa.kv_split_plan(pps, hkv, 16)
    assert (splits, per) == (3, 16)
    span = per * BS
    lengths = np.array([1, BS, BS + 1, span, span + 1, 2 * span + 1,
                        pps * BS, 300], np.int32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    pt[0] = 0
    q32 = rng.randn(B, hq, d).astype(np.float32)
    tdt = getattr(torch, dtype)
    q = torch.from_numpy(q32).to(tdt)
    scale = d ** -0.5
    got = split_merge_math(q, tk, tv, torch.from_numpy(lengths),
                           torch.from_numpy(pt), scale, per)
    plain = tpa._paged_math(q, tk, tv, torch.from_numpy(lengths),
                            torch.from_numpy(pt), scale)
    # jax rounds a Python scale to bf16 before it multiplies a bf16 q (weak
    # typing); the port multiplies in f32. The reference gets q * scale as
    # the port rounds it, and scale 1.
    q_scaled = (q * scale).float().numpy()
    ref = np.asarray(jpa._paged_math(
        jnp.asarray(q_scaled).astype(getattr(jnp, dtype)), jk, jv,
        jnp.asarray(lengths), jnp.asarray(pt), 1.0).astype(jnp.float32))
    assert torch.isfinite(got.float()).all()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **tol)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def _ragged_edges(seed, hq, hkv, d):
    """A decode row, an empty row, a fresh prefill of 70 tokens (no
    multiple of 64), a 5-token chunk starting mid-page (kv 41), a 2-token
    prefill, then 3 pad tokens; pages of 16, 6 pages a row."""
    rng = np.random.RandomState(seed)
    q_lens = np.array([1, 0, 70, 5, 2], np.int32)
    kv_lens = np.array([90, 0, 70, 41, 2], np.int32)
    S, pps = len(q_lens), 6
    P = 1 + S * pps
    jk, tk = _int8_pools(rng, hkv, P, BS, d)
    jv, tv = _int8_pools(rng, hkv, P, BS, d)
    pt = rng.permutation(np.arange(1, P)).reshape(S, pps).astype(np.int32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    T = int(cu[-1]) + 3
    q = rng.randn(T, hq, d).astype(np.float32)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(kv_lens), jnp.asarray(pt),
             jnp.asarray(cu))
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(kv_lens),
             torch.from_numpy(pt), torch.from_numpy(cu))
    return jargs, targs, int(cu[-1])


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 16), (8, 1, 16), (4, 2, 64)])
def test_ragged_int8_edges_match_jax_math_and_pallas(hq, hkv, d):
    jargs, targs, n_valid = _ragged_edges(7, hq, hkv, d)
    scale = d ** -0.5
    math_ref = np.asarray(jrpa._ragged_math(*jargs, scale))
    pallas = np.asarray(jrpa._ragged_pallas(*jargs, scale, interpret=True))
    n = trpa.ragged_paged_attention.launches_int8
    got = trpa.ragged_paged_attention(*targs).numpy()
    assert trpa.ragged_paged_attention.launches_int8 == n   # plain tier
    assert np.isfinite(got).all()
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, math_ref, **tol)   # pads included
    np.testing.assert_allclose(got[:n_valid], pallas[:n_valid], **tol)
