"""Kernel C's launch plan and arithmetic, on the CPU (no card needed).

``ops.weight_only.plan`` picks, from the shapes alone, the bf16 kernel's
N rounding (wgmma's N), its 64- or 128-channel tiles, the thread block
cluster that splits K and the depth of its TMA ring; the kernel
(``csrc/weight_only_linear.cu``) runs exactly what the plan says. Here:

- the plan's constants are the kernel source's (kUnitBytes, kMaxSplits,
  kMaxStages, kSmemLimit, and the consumer warpgroups' rule), read from
  the source text;
- for every row count 1-64 and every projection shape of LLaMA-2-7B,
  LLaMA-2-70B and Mixtral 8x7B (K and N from 1024 to 28672), int8 and
  int4: the block's shared memory within 227 KB and large enough for the
  groups' and the cluster's f32 sums, a ring deep enough that its
  warpgroups cannot wait on each other for ever, at most 8 blocks a
  cluster and no empty block, every output channel and every k covered
  exactly once, N rounded up to
  a multiple of 8, and the same plan from the same shapes (exact
  comparisons: integers);
- the dequantization identities the kernel rests on, bit for bit against
  the reference's rounding for every code: an int8 code's low 7 bits under
  the bf16 exponent of 128, less 128 or 256 by its sign bit, is the code,
  and one bf16 multiply by the scale equals bf16(bf16(q) * bf16(s)); an
  int4 nibble xor 8 under the same exponent, less 136, is the nibble;
- the plain form's one-kernel int8 dequantization (``codes * scale``)
  equals the two-step ``codes.to(dt) * scale.to(dt)`` bit for bit, and the
  port's quantized layer, its codes bit for bit the reference's, matches
  the JAX package's ``weight_only_linear`` on the same numpy inputs (f32:
  1e-5 relative, summation order only; bf16: atol 2e-2, rtol 1e-2, one
  bf16 rounding of the output, as ``tests/test_torch_weight_only.py``).

The kernel takes codes in the reference's per-row layout (no host-side
relayout): ``tests/test_torch_weight_only.py`` holds the codes, the
conversions both ways and the quantized model against the reference.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import weight_only as wo

# (K, N) of every projection: q/k/v/o (k/v narrower under GQA), gate/up,
# down
SHAPES = {
    "llama2_7b": ((4096, 4096), (4096, 11008), (11008, 4096)),
    "llama2_70b": ((8192, 8192), (8192, 1024), (8192, 28672),
                   (28672, 8192)),
    "mixtral_8x7b": ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096)),
}
CASES = [(model, k, n, int4) for model, shapes in SHAPES.items()
         for k, n in shapes for int4 in (False, True)]


def _source_constant(name):
    text = (_build.CSRC / "weight_only_linear.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("py, cu", [
    ("UNIT_BYTES", "kUnitBytes"), ("MAX_SPLITS", "kMaxSplits"),
    ("MAX_STAGES", "kMaxStages"), ("SMEM_LIMIT", "kSmemLimit")])
def test_plan_constants_are_the_kernels(py, cu):
    assert getattr(wo, py) == _source_constant(cu)


def test_plan_warpgroups_are_the_kernels():
    """The kernel's consumer_wgs rule (its one return line, parsed) gives
    every instance the warpgroups the plan reports."""
    text = (_build.CSRC / "weight_only_linear.cu").read_text()
    m = re.search(r"return nt <= (\d+) \? (\d+) : \(int4 \? nt <= (\d+) : "
                  r"nt <= (\d+)\) \? (\d+) : (\d+);", text)
    n1, w1, n4, n8, w2, w3 = map(int, m.groups())
    for int4 in (False, True):
        for nt in range(8, 72, 8):
            want = w1 if nt <= n1 else w2 if nt <= (n4 if int4 else n8) else w3
            assert wo.plan(nt, 4096, 4096, int4).warpgroups == want


@pytest.mark.parametrize("model, k, n, int4", CASES)
def test_plan_fits_and_covers_every_column_and_k_once(model, k, n, int4):
    row_bytes = (k + 1) // 2 if int4 else k
    for rows in range(1, wo.MAX_ROWS + 1):
        p = wo.plan(rows, n, k, int4)
        assert p.nt % 8 == 0 and p.nt - 8 < rows <= p.nt
        # shared memory: the ring and its barriers within an H100 block's,
        # and the ring holds the f32 sums the cluster adds
        assert p.smem_bytes <= wo.SMEM_LIMIT
        assert p.smem_bytes == 1024 + p.stages * (p.stage_bytes + 16)
        assert p.stage_bytes == (p.tile_n * wo.UNIT_BYTES
                                 + wo.unit_k(int4) // 64 * p.nt * 128)
        assert 2 <= p.stages <= wo.MAX_STAGES
        # the sums of the block's other warpgroup groups, or of the
        # cluster's other blocks, one region each
        assert p.tile_n in wo.TILE_SIZES and p.warpgroups in (2, 4, 6)
        groups = p.warpgroups // (p.tile_n // 64)
        sums = (2 if int4 else 1) * (p.nt // 2) * (2 * p.tile_n) * 4
        regions = max(groups - 1, 1)   # the kernel's entry checks this
        assert p.stages * p.stage_bytes >= regions * sums
        # a group keeps its last stage until its next one lands: a stage
        # beyond the groups', unless a block's stages all fit at once
        most = -(-p.units // p.splits)
        assert p.stages >= min(most, groups + 1)
        # the cluster: 1-8 blocks along K, each with work
        assert 1 <= p.splits <= wo.MAX_SPLITS and p.splits <= p.units
        assert p.splits in wo.ACTIVE_CLUSTERS
        # every output channel once: tiles of tile_n
        assert (p.tiles - 1) * p.tile_n < n <= p.tiles * p.tile_n
        # every k once: the ranks' units partition the code row's units
        spans = [(p.units * r // p.splits, p.units * (r + 1) // p.splits)
                 for r in range(p.splits)]   # the kernel's u0 and n_it
        assert spans[0][0] == 0 and spans[-1][1] == p.units
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(u1 > u0 for u0, u1 in spans)
        unit_k = wo.unit_k(int4)
        assert (p.units - 1) * wo.UNIT_BYTES < row_bytes \
            <= p.units * wo.UNIT_BYTES
        assert p.units * unit_k >= k


@pytest.mark.parametrize("model, k, n, int4", CASES)
def test_plan_depends_on_the_shapes_alone(model, k, n, int4):
    for rows in (1, 8, 24, 32, 40, 64):
        fresh = wo.plan.__wrapped__(rows, n, k, int4)
        assert fresh == wo.plan.__wrapped__(rows, n, k, int4)
        assert fresh == wo.plan(rows, n, k, int4)


def test_plan_picks_the_measured_tiles_at_7b():
    """The wave model's choice at LLaMA-2-7B, the fastest of the tiles
    (64, 128) and splits (1-6) timed on the card: 64-channel tiles in
    clusters of 2 for q/k/v/o and down (128 blocks, the 64 clusters within
    the 66 an H100 holds), one 128-channel block a tile at gate/up's 86
    tiles, whose clusters would take 2-3 waves."""
    for rows in (1, 8, 32, 64):
        for int4 in (False, True):
            for n, k, want in ((4096, 4096, (64, 2)), (11008, 4096, (128, 1)),
                               (4096, 11008, (64, 2))):
                p = wo.plan(rows, n, k, int4)
                assert (p.tile_n, p.splits) == want


def _bf16_bits(bits):
    return torch.tensor(bits, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)


def _scales():
    rng = np.random.RandomState(0)
    s = np.concatenate([rng.rand(64) * 0.05, rng.rand(16) * 1e-30,
                        [0.0, 1.0, 3.0e38 / 256, 1e-38]]).astype(np.float32)
    return torch.from_numpy(s).to(torch.bfloat16)


def test_int8_dequant_identity_is_the_references_rounding():
    """Every int8 code q and every scale: (bits 0x4300 | q & 0x7f) - (bits
    0x4300 | q & 0x80), times s once in bf16, is bf16(bf16(q) * bf16(s))
    bit for bit (the kernel's dq8_pair)."""
    q = torch.arange(-128, 128, dtype=torch.int32)
    v = _bf16_bits((0x4300 | (q & 0x7F)).tolist())
    c = _bf16_bits((0x4300 | (q & 0x80)).tolist())
    exact = v - c
    assert torch.equal(exact.float(), q.float())
    s = _scales()
    got = exact[None, :] * s[:, None]
    want = (q.to(torch.int8).to(torch.bfloat16)[None, :].float()
            * s[:, None].float()).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_int4_nibble_identity_is_exact():
    """Every nibble n (-8..7, two's complement): bits 0x4300 | (n ^ 8), less
    136, is n (the kernel's nibbles_bf16)."""
    n = torch.arange(-8, 8, dtype=torch.int32)
    t = _bf16_bits((0x4300 | ((n & 0xF) ^ 8)).tolist())
    got = t - torch.tensor(136.0, dtype=torch.bfloat16)
    assert torch.equal(got.float(), n.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_int8_dequant_in_one_kernel_is_the_two_step(dtype):
    rng = np.random.RandomState(1)
    codes = torch.from_numpy(rng.randint(-127, 128, (48, 80)).astype(np.int8))
    scale = torch.from_numpy((rng.rand(48) * 0.05).astype(np.float32))
    one = codes * scale.to(dtype)[:, None]
    two = codes.to(dtype) * scale.to(dtype)[:, None]
    assert one.dtype == dtype and torch.equal(one, two)


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("K", [64, 65, 130])
def test_layer_matches_reference_weight_only_linear(algo, K):
    """``WeightOnlyLinear`` (codes in the port's per-row layout) against the
    reference's ``weight_only_linear`` over the reference's codes, the same
    numpy weight and x: f32 within 1e-5 relative; bf16 x within one bf16
    rounding of the output."""
    rng = np.random.RandomState(K)
    w = (rng.randn(K, 24) * 0.1).astype(np.float32)
    x = rng.randn(3, 5, K).astype(np.float32)
    lin = torch.nn.Linear(K, 24, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    layer = tq.WeightOnlyLinear(lin, "int4" if "int4" in algo else "int8")
    jc, js = jq.weight_quantize(paddle.to_tensor(w), algo=algo)
    np.testing.assert_array_equal(layer.quant_weight.numpy().T,
                                  np.asarray(jc._data))
    wdt = "int4" if "int4" in algo else "int8"
    want = np.asarray(jq.weight_only_linear(
        paddle.to_tensor(x), jc, weight_scale=js, weight_dtype=wdt)._data)
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_b = np.asarray(jq.weight_only_linear(
        paddle.to_tensor(jnp.asarray(x).astype("bfloat16")), jc,
        weight_scale=js, weight_dtype=wdt)._data.astype(jnp.float32))
    got_b = layer(torch.from_numpy(x).to(torch.bfloat16)).detach().float()
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-2, atol=2e-2)
