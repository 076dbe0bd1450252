"""Port parity: sampling (``paddle_tpu_torch/generation.py``) against the
JAX reference's ``paddle_tpu/generation.py::_make_sampler`` on the CPU.

The reference draws with ``jax.random.categorical(key, logits)``, that is
``argmax(logits + gumbel(key))``; the port's sampler takes the Gumbel noise
itself. Given ``noise = jax.random.gumbel(key, logits.shape)`` the two
must pick identical tokens for greedy, temperature, top-k, top-p and
top-k with top-p, on seeded [4, V] f32 logits. The port's counter-based
noise (``gumbel_noise``) must be a function of (key, token index, vocab
id) alone, and Gumbel-distributed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation import _make_sampler as jax_sampler
from paddle_tpu.generation import prompt_bucket as jax_bucket
from paddle_tpu_torch.generation import (
    _make_sampler, gumbel_noise, prompt_bucket, request_keys,
)

CONFIGS = {
    "greedy": (False, 1.0, 0, 1.0),
    "temperature": (True, 0.7, 0, 1.0),
    "top_k": (True, 1.0, 5, 1.0),
    "top_p": (True, 1.0, 0, 0.9),
    "top_k_top_p": (True, 0.8, 5, 0.9),
}


@pytest.mark.parametrize("vocab", [128, 32000])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sampler_matches_jax_for_the_same_noise(name, vocab):
    rng = np.random.RandomState(vocab + len(name))
    for trial in range(3):
        logits = (rng.randn(4, vocab) * 3).astype(np.float32)
        key = jax.random.PRNGKey(trial)
        noise = np.array(jax.random.gumbel(key, logits.shape))
        want = jax_sampler(*CONFIGS[name], 1.0, 0, None)(
            jnp.asarray(logits), key)
        got = _make_sampler(*CONFIGS[name], 1.0, 0, None)(
            torch.from_numpy(logits), torch.from_numpy(noise))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repetition_penalty_and_min_length_match_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(4, 64) * 3).astype(np.float32)
    seen = rng.rand(4, 64) < 0.3
    eos = int(np.argmax(logits[0]))
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.gumbel(key, logits.shape))
    for n_gen in (0, 5):
        want = jax_sampler(True, 0.9, 0, 1.0, 1.3, 2, eos)(
            jnp.asarray(logits), key, jnp.asarray(seen), n_gen)
        got = _make_sampler(True, 0.9, 0, 1.0, 1.3, 2, eos)(
            torch.from_numpy(logits), torch.from_numpy(noise),
            torch.from_numpy(seen), n_gen)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prompt_bucket_matches_jax():
    for n in (1, 15, 16, 17, 300, 2048):
        assert prompt_bucket(n) == jax_bucket(n)


def test_gumbel_noise_is_counter_based_and_gumbel_distributed():
    keys = request_keys(torch.tensor([0, 0, 1, 0]), torch.tensor([0, 1, 0, 0]))
    assert keys[0] == keys[3] and len(set(keys.tolist())) == 3
    a = gumbel_noise(keys, torch.tensor([0, 0, 0, 0]), 32000)
    b = gumbel_noise(keys[:1], torch.tensor([0]), 32000)
    c = gumbel_noise(keys[:1], torch.tensor([1]), 32000)
    assert a.dtype == torch.float32 and a.shape == (4, 32000)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], a[3])
    assert not torch.equal(a[0], a[1]) and not torch.equal(b, c)
    # Gumbel(0, 1): mean = Euler's gamma, std = pi / sqrt(6)
    x = a.double()
    assert abs(float(x.mean()) - 0.5772) < 0.01
    assert abs(float(x.std()) - 1.2825) < 0.01
    assert bool(torch.isfinite(x).all())
