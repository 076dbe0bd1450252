"""Port parity: flash attention (K1, K2) of paddle_tpu_torch against the JAX
reference on the CPU.

- ``ops.flash_attention._attention_math``, the plain version of the flash
  kernels, against the reference's ``flash_attention_fwd`` (which takes
  ``_xla_attention`` off the TPU), and its gradients against the
  reference's ``jax.vjp`` for dq, dk and dv: MHA and GQA (Hq 4 / Hkv 2),
  causal and full, Sq != Sk with the bottom-right causal mask (both ways
  round), and sequence lengths that are no multiple of any tile. f32 only,
  atol = rtol = 2e-5 (summation order only): in bf16 the reference's math
  tier rounds the logits to bf16 (:379), which neither the TPU kernel nor
  the port's kernel does.
- ``_attention_bwd_math``, the plain version of the backward entries on
  their own inputs (delta from the stored output), against the same
  ``jax.vjp`` in every case, at the same tolerance.
- ``FlashAttention.apply`` on a CPU tensor equals the plain version's
  autograd bit for bit (its CPU tier is that version).
- ``nn.functional``: ``scaled_dot_product_attention`` and
  ``flash_attention`` go to the flash dispatch with no mask and no
  dropout; a mask, or ``sdp_kernel(enable_flash=False)``, takes
  ``_math_attention``, held against the reference's at 2e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.flash_attention import flash_attention_fwd as jax_flash
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)
# name: (Hq, Hkv, Sq, Sk, causal)
CASES = {
    "mha-causal": (4, 4, 37, 37, True),
    "mha-full": (4, 4, 37, 37, False),
    "gqa-causal": (4, 2, 37, 37, True),
    "gqa-full": (4, 2, 37, 37, False),
    "mha-causal-sq<sk": (4, 4, 21, 37, True),
    "gqa-causal-sq<sk": (4, 2, 21, 37, True),
    "gqa-causal-sq>sk": (4, 2, 40, 29, True),
    "gqa-full-sq>sk": (4, 2, 40, 29, False),
}


def _inputs(seed, hq, hkv, sq, sk, B=2, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, sq, hq, D).astype(np.float32)
    k = rng.randn(B, sk, hkv, D).astype(np.float32)
    v = rng.randn(B, sk, hkv, D).astype(np.float32)
    do = rng.randn(B, sq, hq, D).astype(np.float32)
    return q, k, v, do


def _torch_grads(attn, q, k, v, do):
    t = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = attn(*t)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [x.grad.numpy() for x in t]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference_forward_and_vjp(case):
    hq, hkv, sq, sk, causal = CASES[case]
    q, k, v, do = _inputs(11, hq, hkv, sq, sk)
    scale = 0.3
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                 scale=scale),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [out] + list(vjp(jnp.asarray(do)))
    got = _torch_grads(lambda a, b, c: tfa.flash_attention_fwd(
        a, b, c, causal=causal, scale=scale), q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_reference_vjp(case):
    hq, hkv, sq, sk, causal = CASES[case]
    q, k, v, do = _inputs(18, hq, hkv, sq, sk)
    scale = 0.3
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                 scale=scale),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa._attention_bwd_math(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.asarray(out)), torch.from_numpy(do), causal,
        scale)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", ["mha-causal", "gqa-full",
                                  "gqa-causal-sq<sk"])
def test_default_scale_is_inverse_sqrt_head_dim(case):
    hq, hkv, sq, sk, causal = CASES[case]
    q, k, v, _ = _inputs(12, hq, hkv, sq, sk, D=64)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    got = tfa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["mha-causal", "gqa-causal-sq<sk",
                                  "gqa-full"])
def test_function_on_cpu_is_the_plain_autograd(case):
    hq, hkv, sq, sk, causal = CASES[case]
    q, k, v, do = _inputs(13, hq, hkv, sq, sk)
    got = _torch_grads(lambda a, b, c: tfa.FlashAttention.apply(
        a, b, c, causal, 0.25), q, k, v, do)
    want = _torch_grads(lambda a, b, c: tfa._attention_math(
        a, b, c, causal, 0.25), q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _paddle(*arrays):
    return [paddle.to_tensor(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_without_mask_is_the_flash_dispatch(causal):
    q, k, v, _ = _inputs(14, 4, 2, 19, 19)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = TF.scaled_dot_product_attention(*t, is_causal=causal)
    np.testing.assert_array_equal(
        got.numpy(), tfa.flash_attention_fwd(*t, causal=causal).numpy())
    out, softmax = TF.flash_attention(*t, causal=causal)
    assert softmax is None
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    want = JF.scaled_dot_product_attention(*_paddle(q, k, v),
                                           is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)


@pytest.mark.parametrize("kind", ["additive", "bool"])
def test_sdpa_with_mask_takes_math_attention(kind):
    q, k, v, _ = _inputs(15, 4, 2, 19, 19)
    rng = np.random.RandomState(16)
    keep = rng.rand(2, 1, 1, 19) > 0.3
    keep[..., 0] = True                      # every row sees a key
    mask = keep if kind == "bool" else np.where(keep, 0.0, -1e9).astype(
        np.float32)
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    want = JF.scaled_dot_product_attention(
        *_paddle(q, k, v), attn_mask=paddle.to_tensor(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)


def test_sdp_kernel_without_flash_takes_math_attention(monkeypatch):
    q, k, v, _ = _inputs(17, 4, 4, 19, 19)
    t = [torch.from_numpy(a) for a in (q, k, v)]

    def forbidden(*a, **kw):
        raise AssertionError("flash dispatch used under enable_flash=False")

    # the submodule (the package's `flash_attention` is the function)
    module = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    monkeypatch.setattr(module, "flash_attention_fwd", forbidden)
    with TF.sdp_kernel(enable_flash=False):
        got = TF.scaled_dot_product_attention(*t, is_causal=True)
    with JF.sdp_kernel(enable_flash=False):
        want = JF.scaled_dot_product_attention(*_paddle(q, k, v),
                                               is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)
