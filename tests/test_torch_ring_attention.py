"""Port parity: ring attention (K6) and Ulysses attention of
paddle_tpu_torch against the JAX reference on the CPU.

The reference runs its ``ring_attention`` / ``ulysses_attention`` under
``shard_map`` on four devices of the 8-device virtual CPU mesh
(tests/conftest.py); the port runs every rank of a sep-4 mesh
(``build_mesh(sep=4, devices=["cpu"] * 4)``) in one process on the ranks'
shards stacked [n, ...]. Inputs are drawn by numpy from seeds and fed to
both. Tolerances, f32 throughout (the two differ in summation order only):
- outputs within rtol 2e-5, atol 2e-5, for both of the port's tiers
  (blockwise math, and the kernel tier whose kernels run their plain
  versions on the CPU), causal and full, two ``block_k``, MHA and GQA;
- gradients against ``jax.vjp`` of the reference's ring, rtol 2e-5, atol
  2e-5;
- K6's epilogue (``_ring_merge_math``) against the reference's
  ``_online_merge`` on the same visits, rtol 2e-5, atol 2e-6;
- Ulysses against the reference's, rtol 2e-5, atol 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.ops import ring_attention as jra
from paddle_tpu_torch.distributed import build_mesh, mesh_guard
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import ring_attention as tra

N = 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:N]), ("sep",))


def _jax_ring(q, k, v, **kw):
    spec = P(None, None, "sep", None)
    return jax.jit(shard_map(functools.partial(jra.ring_attention,
                                               axis_name="sep", **kw),
                             mesh=_jax_mesh(), in_specs=(spec,) * 3,
                             out_specs=spec, check_rep=False))(q, k, v)


def _stack(x):
    """[B, H, S, D] numpy -> the ranks' shards stacked [n, B, H, S/n, D]."""
    B, H, S, D = x.shape
    return torch.from_numpy(x).reshape(B, H, N, S // N, D).permute(
        2, 0, 1, 3, 4)


def _unstack(y):
    """Inverse of ``_stack`` -> numpy [B, H, S, D]."""
    n, B, H, s, D = y.shape
    return y.detach().permute(1, 2, 0, 3, 4).reshape(B, H, n * s, D).numpy()


def _inputs(seed, B=2, hq=4, hkv=4, S=32, D=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, hq, S, D).astype(np.float32),
            rng.randn(B, hkv, S, D).astype(np.float32),
            rng.randn(B, hkv, S, D).astype(np.float32))


def _port_ring(q, k, v, **kw):
    with mesh_guard(build_mesh(sep=N, devices=["cpu"] * N)):
        return tra.ring_attention(q, k, v, axis_name="sep", **kw)


@pytest.mark.parametrize("impl", ["block", "kernel"])
@pytest.mark.parametrize("block_k", [None, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(causal, block_k, impl):
    q, k, v = _inputs(0)
    want = _jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_k=block_k, impl="block")
    got = _port_ring(_stack(q), _stack(k), _stack(v), causal=causal,
                     block_k=block_k, impl=impl)
    assert tra.LAST_IMPL == f"ring-{impl}"
    np.testing.assert_allclose(_unstack(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["block", "kernel"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gqa_matches_reference(causal, impl):
    """The ring carries the unexpanded kv heads (6 query heads over 2)."""
    q, k, v = _inputs(4, hq=6, hkv=2)
    want = _jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, impl="block")
    got = _port_ring(_stack(q), _stack(k), _stack(v), causal=causal,
                     impl=impl)
    np.testing.assert_allclose(_unstack(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["block-causal", "kernel-causal",
                                  "kernel-full", "kernel-gqa-causal",
                                  "kernel-gqa-full"])
def test_ring_attention_gradients_match_jax_vjp(case):
    """The kernel tier's backward (K1's backward entries per visit, given
    the merged lse and delta, adding into the ring's f32 sums; their plain
    versions here) and autograd of the math tier, against ``jax.vjp`` of
    the reference's ring."""
    impl, *rest = case.split("-")
    causal = rest[-1] == "causal"
    q, k, v = _inputs(1, hkv=2 if "gqa" in rest else 4)
    cot = np.random.RandomState(2).randn(*q.shape).astype(np.float32)

    @jax.jit
    def fwd_vjp(a, b, c, g):
        out, vjp = jax.vjp(lambda a, b, c: _jax_ring(a, b, c, causal=causal,
                                                     impl="block"), a, b, c)
        return out, vjp(g)

    out, want = fwd_vjp(*(jnp.asarray(x) for x in (q, k, v, cot)))
    tq, tk, tv = (_stack(x).detach().requires_grad_() for x in (q, k, v))
    got = _port_ring(tq, tk, tv, causal=causal, impl=impl)
    got.backward(_stack(cot))
    np.testing.assert_allclose(_unstack(got), np.asarray(out), **TOL)
    for g, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(_unstack(g.grad), np.asarray(w), **TOL)


def test_ring_merge_matches_reference_online_merge():
    """K6's epilogue on normalized outputs and log-sum-exps equals the
    reference's merge of unnormalized (o, l, m): seeded from the
    reference's empty state (m -1e30) and from the port's first visit, then
    merged with a second visit."""
    rng = np.random.RandomState(5)
    B, H, S, D = 2, 3, 16, 8
    o1, o2 = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.uniform(0.5, 20, (B, H, S)).astype(np.float32)
              for _ in range(2))
    m1, m2 = (rng.randn(B, H, S).astype(np.float32) * 3 for _ in range(2))
    o, l, m = jra._online_merge(jnp.zeros((B, H, S, D)), jnp.zeros((B, H, S)),
                                jnp.full((B, H, S), -1e30), jnp.asarray(o1),
                                jnp.asarray(l1), jnp.asarray(m1))
    o, l, m = jra._online_merge(o, l, m, jnp.asarray(o2), jnp.asarray(l2),
                                jnp.asarray(m2))
    want_o = np.asarray(o / l[..., None]).transpose(0, 2, 1, 3)
    want_lse = np.asarray(m + jnp.log(l))

    def port(x):   # [B, H, S, D] -> the port's [B, S, H, D]
        return torch.from_numpy(x.transpose(0, 2, 1, 3).copy())

    lse1 = torch.from_numpy(m1 + np.log(l1))
    lse2 = torch.from_numpy(m2 + np.log(l2))
    empty = torch.full_like(lse1, float("-inf"))
    acc, acc_lse = tfa._ring_merge_math(torch.zeros(B, S, H, D), empty,
                                        port(o1), lse1)
    np.testing.assert_allclose(acc.numpy(), port(o1).numpy(), rtol=0, atol=0)
    got, got_lse = tfa._ring_merge_math(acc, acc_lse, port(o2), lse2)
    np.testing.assert_allclose(got.numpy(), want_o, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-5,
                               atol=2e-6)
    # a row that saw no key on either side stays 0, not NaN
    o0, lse0 = tfa._ring_merge_math(torch.ones(1, 2, 1, 4),
                                    torch.full((1, 1, 2), float("-inf")),
                                    torch.ones(1, 2, 1, 4),
                                    torch.full((1, 1, 2), float("-inf")))
    assert not o0.any() and bool((lse0 == float("-inf")).all())


@pytest.mark.parametrize("causal", [True, False])
def test_ring_visit_backward_adds_into_the_ring_sums(causal):
    """One visit's backward adds its gradients into the ring's f32 sums (on
    the card in the kernels' epilogue; here through the plain version):
    sums already holding another visit's gradients come out holding both,
    the inputs unchanged, and no launch is counted."""
    rng = np.random.RandomState(8)
    q, do, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   for shape in [(2, 8, 6, 8)] * 2 + [(2, 8, 2, 8)] * 2)
    lse = torch.from_numpy(rng.randn(2, 6, 8).astype(np.float32)) + 3
    delta = torch.from_numpy(rng.randn(2, 6, 8).astype(np.float32))
    before = [torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
              for t in (q, k, v)]
    sums = [t.clone() for t in before]
    counts = [f.launches for f in tfa.KERNELS]
    tra._visit_bwd(q, k, v, do, lse, delta, causal, 0.3, *sums)
    grads = tra._visit_bwd_math(q, k, v, do, lse, delta, causal, 0.3)
    for got, b, g in zip(sums, before, grads):
        torch.testing.assert_close(got, b + g, rtol=0, atol=0)
    assert [f.launches for f in tfa.KERNELS] == counts


def test_ring_flash_fwd_plain_version_merges_in_place():
    """On a CPU tensor the K6 wrapper runs its plain version: a first
    visit seeds the state, a later one merges into it in place, the last
    writes the merged output in q's dtype; and it counts no launch."""
    rng = np.random.RandomState(6)
    q, k1, v1, k2, v2 = (torch.from_numpy(
        rng.randn(2, 8, 4, 8).astype(np.float32)) for _ in range(5))
    n0 = tfa.ring_flash_fwd.launches
    o_acc = torch.empty(q.shape)
    lse = torch.empty(2, 4, 8)
    tfa.ring_flash_fwd(q, k1, v1, o_acc, lse, True, 0.3, first=True)
    out = torch.empty_like(q)
    tfa.ring_flash_fwd(q, k2, v2, o_acc, lse, False, 0.3, out=out)
    want = tfa._attention_math(q, torch.cat([k2, k1], 1),
                               torch.cat([v2, v1], 1), True, 0.3)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)
    assert tfa.ring_flash_fwd.launches == n0


@pytest.mark.parametrize("case", ["full", "causal", "gqa-causal"])
def test_ulysses_attention_matches_reference(case):
    causal = case.endswith("causal")
    rng = np.random.RandomState(2)
    B, S, D = 1, 16, 8
    hkv = 4 if case != "gqa-causal" else 8
    hq = 4 if case != "gqa-causal" else 16
    q = rng.randn(B, S, hq, D).astype(np.float32)
    k, v = (rng.randn(B, S, hkv, D).astype(np.float32) for _ in range(2))
    spec = P(None, "sep", None, None)
    want = jax.jit(shard_map(functools.partial(jra.ulysses_attention,
                                               axis_name="sep", causal=causal),
                             mesh=_jax_mesh(), in_specs=(spec,) * 3,
                             out_specs=spec, check_rep=False))(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), hq // hkv, 2),
        jnp.repeat(jnp.asarray(v), hq // hkv, 2))

    def stack(x):   # [B, S, H, D] -> [n, B, S/n, H, D]
        return torch.from_numpy(x).reshape(B, N, S // N, *x.shape[2:]
                                           ).transpose(0, 1)

    def attn(qq, kk, vv):
        # each rank's head group arrives whole, as the kernels take it
        assert all(t.is_contiguous() for t in (qq, kk, vv))
        return tfa._attention_math(qq, kk, vv, causal, D ** -0.5)

    with mesh_guard(build_mesh(sep=N, devices=["cpu"] * N)):
        got = tra.ulysses_attention(stack(q), stack(k), stack(v), "sep",
                                    causal=causal, attn_impl=attn)
    got = got.transpose(0, 1).reshape(B, S, hq, D).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_ring_attention_needs_its_mesh():
    q = torch.zeros(N, 1, 2, 8, 8)
    with pytest.raises(ValueError, match="needs a mesh"):
        tra.ring_attention(q, q, q)
    with mesh_guard(build_mesh(sep=2, devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="4 shards on a sep axis of 2"):
            tra.ring_attention(q, q, q)
    with mesh_guard(build_mesh(sep=N, devices=["cpu"] * N)):
        with pytest.raises(ValueError, match="impl must be"):
            tra.ring_attention(q, q, q, impl="splash")
        with pytest.raises(ValueError, match="divisible by the axis size"):
            tra.ulysses_attention(*(torch.zeros(N, 1, 2, 6, 8),) * 3)


def test_ring_visits_and_shift():
    """Step i: rank my holds src = (my + i) % n; causal keeps src <= my,
    n (n + 1) / 2 visits, each rank's diagonal first; the shift is the
    reference's back permutation (rank j receives rank j + 1's shard)."""
    steps = tra._visits(4, True)
    assert [[(my, src) for my, src, _ in s] for s in steps] == [
        [(0, 0), (1, 1), (2, 2), (3, 3)], [(3, 0)], [(2, 0), (3, 1)],
        [(1, 0), (2, 1), (3, 2)]]
    assert all(d for _, _, d in steps[0])
    assert sum(len(s) for s in tra._visits(4, False)) == 16
    assert tra._ring_shift([0, 1, 2, 3]) == [1, 2, 3, 0]
    assert tra._pick_block_k(24, None) == 24
    assert tra._pick_block_k(24, 16) == 8
    assert tra._pick_block_k(2048, None) == 512
