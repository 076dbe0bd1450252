"""Port parity for the paged attention kernels' design over every pool
type (int8 codes with row scales, bf16, f32), on the CPU.

- the split plan of the split-KV decode kernel (``kv_split_plan``): every
  page of every length 1 .. pages_per_seq * bs lies in exactly one split;
- the split-and-merge, stated here in plain PyTorch the way K5 computes it
  (per-split partials, scores in base 2 with the key factor log2(e) times
  an int8 pool's hoisted k_scale / 127.5, the weights taking v_scale /
  127.5 or 1, merged in split order), against the port's ``_paged_math``
  and the reference's ``paddle_tpu/ops/paged_attention.py::_paged_math``
  over the same pools, at lengths on page and split edges: f32 1e-5; a
  bf16 q (over an int8 or a bf16 pool) at the card's bf16 tolerance (atol
  2e-2, rtol 1e-2: one bf16 rounding of the output);
- K4's plain version (``_ragged_math``) on the tile kernel's edges (a
  decode row, an empty row, a fresh prefill of a chunk that is no multiple
  of the 64-pair tile, a chunk starting mid-page, a 2-token prefill, pad
  tokens) against the reference's ``_ragged_math`` and its Pallas kernel
  in interpret mode, over every pool type: 2e-5 in f32 (int8 and f32
  pools), the bf16 tolerance over a bf16 pool (bf16 q);
- the paged kernels' wrappers refuse a page size that is no multiple of
  16 (``check_geometry``, which both call before any launch).
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
    """K5's arithmetic in plain PyTorch: q * scale rounded to q's dtype;
    per split, base-2 scores (q . k) times the key factor (log2(e), and
    for an int8 pool k_scale / 127.5 with k the codes), the split's max m,
    sum of weights l and unnormalised o with the weights taking the value
    factor (an int8 pool's v_scale / 127.5, else 1); then the splits merged
    in order. An empty split is (-inf, 0, 0)."""
    B, Hq, D = q.shape
    quant = isinstance(k_pages, QuantizedTensor)
    if quant:
        kc, ks = k_pages.weight, k_pages.scales[..., 0] * (LOG2E / 127.5)
        vc, vs = v_pages.weight, v_pages.scales[..., 0] / 127.5
    else:
        kc, vc = k_pages, v_pages
        ks = torch.full(kc.shape[:3], LOG2E)
        vs = torch.ones(vc.shape[:3])
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
            krow = kc[:, pid].reshape(Hkv, keys, D).float()
            vrow = vc[:, pid].reshape(Hkv, keys, D).float()
            kf = ks[:, pid].reshape(Hkv, keys)
            vf = vs[:, pid].reshape(Hkv, keys)
            sc = torch.einsum("hgd,hkd->hgk", qs[b], krow) * kf[:, None]
            sc = torch.where(live, sc, -math.inf)
            m = sc.amax(-1)
            p = torch.exp2(sc - m[..., None])
            o = torch.einsum("hgk,hkd->hgd", p * vf[:, None], vrow)
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


def _pools(pool, rng, hkv, P, bs, D):
    """The same pool of type ``pool`` (int8, bfloat16, float32) on both
    sides; a bf16 pool holds seeded f32 rows rounded to bf16."""
    if pool == "int8":
        return _int8_pools(rng, hkv, P, bs, D)
    f = (rng.randn(hkv, P, bs, D)
         * rng.lognormal(0.0, 1.0, (hkv, P, bs, 1))).astype(np.float32)
    t = torch.from_numpy(f).to(getattr(torch, pool))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, pool)), t


# (pool, q dtype): an int8 pool is read by an f32 and a bf16 q, a float
# pool by a q of its own dtype
POOL_CASES = [("int8", "float32"), ("int8", "bfloat16"),
              ("bfloat16", "bfloat16"), ("float32", "float32")]


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (8, 2, 128), (8, 1, 64)])
@pytest.mark.parametrize("pool,dtype", POOL_CASES)
def test_split_and_merge_matches_plain_and_jax(hq, hkv, d, pool, dtype):
    """Eight rows at page and split edges (pages of 16, 48 pages a row,
    splits of 16 pages: 1, bs, bs + 1, one split, one past it, two splits
    and one past, the whole row), row 0 frozen at the scratch page."""
    rng = np.random.RandomState(hq * 100 + d)
    pps = 48
    B = 8
    P = 1 + B * pps
    jk, tk = _pools(pool, rng, hkv, P, BS, d)
    jv, tv = _pools(pool, rng, hkv, P, BS, d)
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


def _ragged_edges(seed, hq, hkv, d, pool="int8", dtype="float32"):
    """A decode row, an empty row, a fresh prefill of 70 tokens (no
    multiple of 64), a 5-token chunk starting mid-page (kv 41), a 2-token
    prefill, then 3 pad tokens; pages of 16, 6 pages a row. q is rounded to
    ``dtype``; a bf16 q reaches the reference as q * scale rounded as the
    port rounds it, with scale 1 (jax would round the scale to bf16 first).
    Returns the reference's arguments and scale, the port's arguments and
    the count of valid tokens."""
    rng = np.random.RandomState(seed)
    q_lens = np.array([1, 0, 70, 5, 2], np.int32)
    kv_lens = np.array([90, 0, 70, 41, 2], np.int32)
    S, pps = len(q_lens), 6
    P = 1 + S * pps
    jk, tk = _pools(pool, rng, hkv, P, BS, d)
    jv, tv = _pools(pool, rng, hkv, P, BS, d)
    pt = rng.permutation(np.arange(1, P)).reshape(S, pps).astype(np.int32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    T = int(cu[-1]) + 3
    q = torch.from_numpy(rng.randn(T, hq, d).astype(np.float32)).to(
        getattr(torch, dtype))
    scale = d ** -0.5
    if dtype == "bfloat16":
        jq, jscale = (q * scale).float().numpy(), 1.0
    else:
        jq, jscale = q.numpy(), scale
    jargs = (jnp.asarray(jq).astype(getattr(jnp, dtype)), jk, jv,
             jnp.asarray(kv_lens), jnp.asarray(pt), jnp.asarray(cu))
    targs = (q, tk, tv, torch.from_numpy(kv_lens), torch.from_numpy(pt),
             torch.from_numpy(cu))
    return jargs, jscale, targs, int(cu[-1])


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 16), (8, 1, 16), (4, 2, 64)])
@pytest.mark.parametrize("pool,dtype", [("int8", "float32"),
                                        ("bfloat16", "bfloat16"),
                                        ("float32", "float32")])
def test_ragged_int8_edges_match_jax_math_and_pallas(hq, hkv, d, pool,
                                                      dtype):
    """Every pool type (int8 and f32 pools with an f32 q at 2e-5, a bf16
    pool with a bf16 q at the bf16 tolerance): the port's plain version
    on the tile kernel's edges against the reference's math and its Pallas
    kernel in interpret mode, pads included for the math."""
    jargs, jscale, targs, n_valid = _ragged_edges(7, hq, hkv, d, pool,
                                                  dtype)
    math_ref = np.asarray(jrpa._ragged_math(*jargs, jscale)
                          .astype(jnp.float32))
    pallas = np.asarray(jrpa._ragged_pallas(*jargs, jscale, interpret=True)
                        .astype(jnp.float32))
    wrapper = trpa.ragged_paged_attention
    n = (wrapper.launches, wrapper.launches_int8)
    got = wrapper(*targs).float().numpy()
    assert (wrapper.launches, wrapper.launches_int8) == n   # plain tier
    assert np.isfinite(got).all()
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, math_ref, **tol)   # pads included
    np.testing.assert_allclose(got[:n_valid], pallas[:n_valid], **tol)


@pytest.mark.parametrize("kernel", ["paged_decode_attention",
                                    "ragged_paged_attention"])
@pytest.mark.parametrize("page_size", [8, 24, 40])
def test_paged_wrappers_refuse_a_page_size_off_16(kernel, page_size):
    """Both wrappers run ``check_geometry`` on the operands' shapes before
    a launch (after loading the kernel's library, so no CUDA-less call
    reaches it through the wrapper itself): a page size that is no
    multiple of 16 is refused, for float pools as for int8 ones."""
    with pytest.raises(ValueError, match="multiple of 16"):
        tpa.check_geometry(kernel, 32, 8, page_size, 128)
    tpa.check_geometry(kernel, 32, 8, page_size + 16 - page_size % 16, 128)
    assert trpa.check_geometry is tpa.check_geometry
