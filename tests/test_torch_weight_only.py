"""Port parity: weight-only int8/int4 quantization (``paddle_tpu_torch
.nn.quant`` and ``ops.weight_only``, kernel C's plain version) against the
JAX reference's ``paddle_tpu/nn/quant`` on the CPU, inputs drawn by numpy
from seeds. Each test mirrors one of ``tests/test_weight_only_quant.py``.

Tolerances:
- codes and scales, int8 and int4, odd K and an all-zero output channel
  among them: bit for bit; ``weight_dequantize``: bit for bit;
- ``weight_only_linear``'s plain version against the reference's: f32
  rtol 1e-5 (atol 1e-5; summation order only), bf16 chip_smoke's
  TOLERANCE (atol 2e-2, rtol 1e-2: one bf16 rounding of the output);
- ``quantize_for_inference`` swaps the modules the reference swaps, by
  name, with and without the head skipped; a quantized ``llama_tiny``'s
  logits within 1e-4 of the reference's (f32), and its greedy
  ``generate`` tokens identical, int8 and int4;
- ``load_paddle_tpu_state`` / ``export_paddle_tpu_state`` carry the
  reference's ``quant_weight`` ([K, N] / [ceil(K/2), N]) and
  ``weight_scale`` buffers both ways bit for bit;
- kernel C's wrapper given a CUDA tensor raises when its kernel cannot be
  had, without running the plain version or counting a launch.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import weight_only as two

ALGOS = ("weight_only_int8", "weight_only_int4")


def _weight(seed, K, N=12):
    rng = np.random.RandomState(seed)
    w = (rng.randn(K, N) * rng.rand(N)).astype(np.float32)
    w[:, 3] = 0.0          # an all-zero output channel: scale 0, codes 0
    return w


@pytest.mark.parametrize("K", [64, 65, 9])
@pytest.mark.parametrize("algo", ALGOS)
def test_codes_and_scales_match_reference_bit_for_bit(algo, K):
    w = _weight(K, K)
    jc, js = jq.weight_quantize(paddle.to_tensor(w), algo=algo)
    tc, ts = tq.weight_quantize(torch.from_numpy(w), algo=algo)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._data))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js._data).view(np.int32))
    assert (tc.numpy()[:, 3] == 0).all() and ts[3] == 0
    jd = jq.weight_dequantize(jc, js, algo=algo, k=K)
    td = tq.weight_dequantize(tc, ts, algo=algo, k=K)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd._data))


def test_quantize_rows_is_the_transpose_of_the_reference_layout():
    w = _weight(1, 33)
    for algo, int4 in zip(ALGOS, (False, True)):
        codes, scale = tq.quantize_rows(torch.from_numpy(w.T), int4)
        tc, ts = tq.weight_quantize(torch.from_numpy(w), algo=algo)
        assert torch.equal(codes, tc.t()) and torch.equal(scale, ts)
        full = tq.unpack_rows(codes, 33) if int4 else codes
        assert full.shape == (12, 33) and int(full.abs().max()) == (
            7 if int4 else 127)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [64, 65])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_plain_matches_reference(algo, K, dtype):
    w = _weight(2 * K, K, N=40)
    rng = np.random.RandomState(K)
    x = rng.randn(3, 5, K).astype(np.float32)
    bias = rng.randn(40).astype(np.float32)
    wdt = "int4" if algo.endswith("int4") else "int8"
    jc, js = jq.weight_quantize(paddle.to_tensor(w), algo=algo)
    want = jq.weight_only_linear(
        paddle.to_tensor(jnp.asarray(x).astype(dtype)), jc,
        paddle.to_tensor(bias), js, weight_dtype=wdt)
    tc, ts = tq.weight_quantize(torch.from_numpy(w), algo=algo)
    got = tq.weight_only_linear(
        torch.from_numpy(x).to(getattr(torch, dtype)), tc.t().contiguous(),
        torch.from_numpy(bias), ts, weight_dtype=wdt)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 5, 40)
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (2e-2, 1e-2)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want._data.astype(jnp.float32)),
        rtol=rtol, atol=atol)


def _pair(seed=21, layers=2):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(num_hidden_layers=layers))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=layers), device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _swapped(model, cls):
    mods = (model.named_modules() if isinstance(model, torch.nn.Module)
            else model.named_sublayers())
    return sorted(n for n, m in mods if isinstance(m, cls))


@pytest.mark.parametrize("skip_head", [False, True])
def test_quantize_for_inference_swaps_the_reference_names(skip_head):
    jm, tm = _pair()

    def skip(name, layer):
        return skip_head and name == "lm_head"

    jq.quantize_for_inference(jm, "int8", skip=skip)
    tq.quantize_for_inference(tm, "int8", skip=skip)
    names = _swapped(tm, tq.WeightOnlyLinear)
    assert names == _swapped(jm, jq.WeightOnlyLinear)
    assert len(names) == 2 * 7 + (0 if skip_head else 1)
    assert ("lm_head" in names) != skip_head
    assert not any(isinstance(m, torch.nn.Linear) and n != "lm_head"
                   for n, m in tm.named_modules())
    assert all(not p.requires_grad or "quant" not in n
               for n, p in tm.named_parameters())


def _quantized_pair(wdt):
    jm, tm = _pair()
    jq.quantize_for_inference(jm, wdt)
    tq.quantize_for_inference(tm, wdt)
    return jm, tm


@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_quantized_model_matches_reference(wdt):
    """Logits within 1e-4 (f32), greedy tokens identical, and the cache's
    dtype probed from the dequantized head (f32), as the reference's."""
    jm, tm = _quantized_pair(wdt)
    ids = np.random.RandomState(5).randint(0, 128, (2, 11)).astype(np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jm(paddle.to_tensor(ids)).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert tm.init_cache(1, 16)[0][0].dtype == torch.float32
    want = np.asarray(jm.generate(ids, max_new_tokens=8).numpy())
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=8).numpy(), want)


@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_convert_carries_quantized_buffers_both_ways(wdt):
    """The reference's quantized state (parameters and the codes' and
    scales' buffers) loads into a quantized port model bit for bit, the
    codes equal the port's own quantization, and the export gives the
    reference's arrays back."""
    jm, tm = _quantized_pair(wdt)
    ref = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    ref.update({n: np.asarray(b._data) for n, b in jm.named_buffers()})
    assert any(n.endswith("quant_weight") for n in ref)
    fresh = copy.deepcopy(tm)
    for m in fresh.modules():
        if isinstance(m, tq.WeightOnlyLinear):
            m.quant_weight.zero_()
            m.weight_scale.zero_()
    load_paddle_tpu_state(fresh, ref)
    for (n, a), (_, b) in zip(fresh.named_buffers(), tm.named_buffers()):
        assert torch.equal(a, b), n
    out = export_paddle_tpu_state(fresh)
    assert sorted(out) == sorted(ref)
    for n, a in ref.items():
        assert out[n].dtype == (np.int8 if a.dtype == np.int8
                                else np.float32), n
        np.testing.assert_array_equal(out[n], a, err_msg=n)


class _CudaStub:
    """Stands in for a CUDA tensor: the wrapper picks its route from the
    device and the row count before touching anything else."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device("cuda", 0)

    def numel(self):
        return int(np.prod(self.shape))


def test_kernel_c_wrapper_raises_without_its_kernel(monkeypatch):
    def missing(name):
        raise _build.KernelBuildError(f"lib{name} is not built here")

    def plain_forbidden(*a, **k):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(_build, "library", missing)
    monkeypatch.setattr(two, "_wo_math", plain_forbidden)
    before = (two.weight_only_matmul.launches,
              two.weight_only_matmul.plain_calls)
    for int4 in (False, True):
        with pytest.raises(_build.KernelBuildError,
                           match="weight_only_linear"):
            two.weight_only_matmul(_CudaStub(8, 4096), None, None, int4, 4096)
    assert (two.weight_only_matmul.launches,
            two.weight_only_matmul.plain_calls) == before
