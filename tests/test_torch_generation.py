"""Port parity: generation on the dense caches (``paddle_tpu_torch``'s
``GenerationMixin`` and ``LlamaForCausalLM``'s fixed and growing caches)
against the JAX reference on the CPU, at ``llama_tiny`` sizes (vocab 128,
2 layers; the drafts 1 layer), with the reference's weights carried over
by ``load_paddle_tpu_state`` and prompts drawn by numpy from seeds. Each
test mirrors one of ``tests/test_inference.py`` or
``tests/test_speculative.py``.

Tolerances:
- logits of the fixed cache (prefill, then one token at a time) against
  the reference's and against the port's full-context forward: 1e-5 (f32;
  the two differ in summation order only); the growing cache the same
  way: at the reference's default positions (0..S-1 of each forward)
  against the reference's, and at absolute positions against the full
  context (the reference's rope table covers the new tokens only, so it
  has no finite logits there);
- token ids: identical to the reference's for greedy, eos/pad,
  min_length, repetition penalty, right- and left-padded
  ``attention_mask`` batches, beam search (K 2 and 4, length penalty 0
  and 1, eos, and num_beams == V, exhaustive over two tokens) and
  speculative decoding (gamma 1, 3, 4 x B 1, 2, equal to the port's own
  greedy too); sampled paths (temperature, top-k, top-p) given the
  reference's own Gumbel noise for each draw (its key schedule,
  generation.py:534-557 and :242-265), through the port's noise seam
  ``generation._draw_noise``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

V = 128


def _pair(seed=21, layers=2, **kw):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(num_hidden_layers=layers, **kw))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=layers, **kw),
                          device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def drafts():
    return _pair(seed=22, layers=1)


def _ids(seed, B, S):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _same(jm, tm, ids, **kw):
    want = np.asarray(jm.generate(ids, **kw).numpy())
    got = tm.generate(ids, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


# -- the caches ---------------------------------------------------------------

def test_fixed_cache_matches_reference_and_full_context(models):
    jm, tm = models
    ids = _ids(0, 2, 10)
    with torch.no_grad():
        full = tm(torch.from_numpy(ids)).numpy()
        caches = tm.init_cache(2, 16)
        assert caches[0][0].shape == (2, 16, 4, 16)
        lg, caches = tm(torch.from_numpy(ids[:, :6]), past_key_values=caches,
                        cache_position=0, use_cache=True)
        steps = [lg.numpy()]
        for t in range(6, 10):
            lg, caches = tm(torch.from_numpy(ids[:, t:t + 1]),
                            past_key_values=caches, cache_position=t,
                            use_cache=True)
            steps.append(lg.numpy())
    got = np.concatenate(steps, axis=1)
    jc = [(paddle.Tensor(k), paddle.Tensor(v)) for k, v in jm.init_cache(2, 16)]
    jl, jc = jm(paddle.to_tensor(ids[:, :6]), past_key_values=jc,
                cache_position=paddle.to_tensor(np.int32(0)), use_cache=True)
    want = [jl.numpy()]
    for t in range(6, 10):
        jl, jc = jm(paddle.to_tensor(ids[:, t:t + 1]), past_key_values=jc,
                    cache_position=paddle.to_tensor(np.int32(t)),
                    use_cache=True)
        want.append(jl.numpy())
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5)


def test_growing_cache_matches_reference_and_full_context(models):
    jm, tm = models
    ids = _ids(1, 2, 10)
    cfg = tm.config
    empty = (2, 0, cfg.num_key_value_heads, cfg.head_dim)
    jc = [(paddle.Tensor(jnp.zeros(empty)),) * 2 for _ in range(2)]
    jl, jc = jm(paddle.to_tensor(ids[:, :6]), past_key_values=jc,
                use_cache=True)
    want = [jl.numpy()]
    for t in range(6, 10):
        jl, jc = jm(paddle.to_tensor(ids[:, t:t + 1]), past_key_values=jc,
                    use_cache=True)
        want.append(jl.numpy())
    with torch.no_grad():
        full = tm(torch.from_numpy(ids)).numpy()
        for absolute in (False, True):
            caches = [(torch.zeros(empty),) * 2 for _ in range(2)]
            lg, caches = tm(torch.from_numpy(ids[:, :6]),
                            past_key_values=caches, use_cache=True)
            got = [lg.numpy()]
            for t in range(6, 10):
                pos = torch.full((2, 1), t) if absolute else None
                lg, caches = tm(torch.from_numpy(ids[:, t:t + 1]),
                                position_ids=pos, past_key_values=caches,
                                use_cache=True)
                got.append(lg.numpy())
            assert caches[0][0].shape == (2, 10, 4, 16)
            got = np.concatenate(got, axis=1)
            ref = full if absolute else np.concatenate(want, axis=1)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# -- generate -----------------------------------------------------------------

@pytest.mark.parametrize("B,S", [(1, 5), (2, 5), (2, 17)])
def test_greedy_matches_reference(models, B, S):
    jm, tm = models
    out = _same(jm, tm, _ids(S, B, S), max_new_tokens=6)
    assert out.shape == (B, S + 6)


def test_eos_pad_and_min_length_match_reference(models):
    jm, tm = models
    ids = np.array([[1, 2, 3]], np.int32)
    eos = int(np.asarray(jm.generate(ids, max_new_tokens=4).numpy())[0, 3])
    out = _same(jm, tm, ids, max_new_tokens=6, eos_token_id=eos,
                pad_token_id=0)
    hit = np.where(out[0, 3:] == eos)[0]
    assert len(hit) and (out[0, 3 + hit[0] + 1:] == 0).all()
    first = int(out[0, 3])
    out = _same(jm, tm, ids, max_new_tokens=6, eos_token_id=first,
                min_length=4, pad_token_id=0)
    assert first not in out[0, 3:7].tolist()


def test_repetition_penalty_matches_reference(models):
    jm, tm = models
    _same(jm, tm, _ids(7, 2, 5), max_new_tokens=12, repetition_penalty=5.0)


def test_attention_mask_batches_match_reference(models):
    """Rows of 5 and 9 tokens, padded on the right, on the left, and a
    ragged batch with the repetition penalty and min_length; each row
    also equals its own unpadded generate."""
    jm, tm = models
    rng = np.random.RandomState(11)
    r0 = rng.randint(0, V, 5).astype(np.int32)
    r1 = rng.randint(0, V, 9).astype(np.int32)
    for left in (False, True):
        ids = np.zeros((2, 9), np.int32)
        mask = np.zeros((2, 9), np.int32)
        for i, r in enumerate((r0, r1)):
            sl = slice(9 - len(r), 9) if left else slice(0, len(r))
            ids[i, sl], mask[i, sl] = r, 1
        out = _same(jm, tm, ids, max_new_tokens=4, attention_mask=mask)
        for i, r in enumerate((r0, r1)):
            alone = tm.generate(r[None], max_new_tokens=4).numpy()
            np.testing.assert_array_equal(out[i, 9:], alone[0, len(r):])
    _same(jm, tm, ids, max_new_tokens=6, attention_mask=mask,
          repetition_penalty=4.0, eos_token_id=int(out[0, 9]), min_length=3,
          pad_token_id=0)


def _reference_noise(seed, max_new):
    """The reference's Gumbel noise of draw i: the first token's from the
    key split off PRNGKey(seed), draw i >= 1 from split(key, max_new - 1)
    [i - 1]."""
    key, first = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(key, max_new - 1)

    def draw(seed_, rows, index, vocab, device):
        k = first if index == 0 else keys[index - 1]
        return torch.from_numpy(np.array(
            jax.random.gumbel(k, (rows, vocab), jnp.float32)))

    return draw


SAMPLING = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.9),
    "top_k_top_p_penalty": dict(temperature=0.8, top_k=8, top_p=0.9,
                                repetition_penalty=1.3),
}


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_sampling_matches_reference_given_its_noise(models, monkeypatch,
                                                    name):
    jm, tm = models
    kw = dict(max_new_tokens=7, do_sample=True, seed=3, **SAMPLING[name])
    monkeypatch.setattr(tgen, "_draw_noise", _reference_noise(3, 7))
    _same(jm, tm, _ids(8, 2, 6), **kw)
    mask = np.array([[1] * 6, [0, 0, 1, 1, 1, 1]], np.int32)
    _same(jm, tm, _ids(9, 2, 6), attention_mask=mask, **kw)


def test_port_noise_is_keyed_by_seed_row_and_index(models):
    _, tm = models
    ids = _ids(10, 2, 5)
    a = tm.generate(ids, max_new_tokens=6, do_sample=True, seed=4)
    b = tm.generate(ids, max_new_tokens=6, do_sample=True, seed=4)
    c = tm.generate(ids, max_new_tokens=6, do_sample=True, seed=5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = tgen._draw_noise(4, 2, 1, V, "cpu")
    assert not torch.equal(noise[0], noise[1])
    assert torch.equal(noise, tgen._draw_noise(4, 2, 1, V, "cpu"))


# -- beam search --------------------------------------------------------------

@pytest.mark.parametrize("K,penalty,eos", [(2, 0.0, None), (4, 1.0, None),
                                           (4, 1.0, 9), (2, 0.0, 9)])
def test_beam_matches_reference(models, K, penalty, eos):
    jm, tm = models
    _same(jm, tm, _ids(3, 2, 7), max_new_tokens=5, num_beams=K,
          length_penalty=penalty, eos_token_id=eos,
          decode_strategy="beam_search")


def test_full_width_beam_is_exhaustive():
    """num_beams == V over two new tokens is exhaustive search: the
    result is the brute-force argmax of logp(v1) + logp(v2 | v1), and the
    reference's (V 32)."""
    jm, tm = _pair(seed=11, vocab_size=32)
    ids = np.random.RandomState(3).randint(0, 32, (1, 6)).astype(np.int32)
    out = _same(jm, tm, ids, max_new_tokens=2, num_beams=32,
                decode_strategy="beam_search")
    with torch.no_grad():
        lp1 = torch.log_softmax(tm(torch.from_numpy(ids))[0, -1], -1)
        seqs = np.concatenate([np.repeat(ids, 32, axis=0),
                               np.arange(32, dtype=np.int32)[:, None]], 1)
        lp2 = torch.log_softmax(tm(torch.from_numpy(seqs))[:, -1], -1)
    v1, v2 = np.unravel_index(int((lp1[:, None] + lp2).argmax()), (32, 32))
    assert (out[0, -2], out[0, -1]) == (v1, v2)


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = tgen._top_k(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4]]
    assert vals.tolist() == np.asarray(want_v).tolist()


# -- speculative decoding -----------------------------------------------------

@pytest.mark.parametrize("gamma", [1, 3, 4])
@pytest.mark.parametrize("B", [1, 2])
def test_speculative_matches_reference_and_greedy(models, drafts, gamma, B):
    jm, tm = models
    jd, td = drafts
    ids = _ids(gamma + 10 * B, B, 6)
    want = np.asarray(jm.generate_speculative(ids, jd, max_new_tokens=9,
                                              gamma=gamma).numpy())
    got = tm.generate_speculative(ids, td, max_new_tokens=9, gamma=gamma)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tm.generate(ids, max_new_tokens=9).numpy())


def test_speculative_with_eos_matches_reference(models, drafts):
    jm, tm = models
    jd, td = drafts
    ids = _ids(30, 2, 6)
    eos = int(tm.generate(ids, max_new_tokens=3).numpy()[1, -1])
    want = np.asarray(jm.generate_speculative(
        ids, jd, max_new_tokens=8, gamma=3, eos_token_id=eos,
        pad_token_id=0).numpy())
    got = tm.generate_speculative(ids, td, max_new_tokens=8, gamma=3,
                                  eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_with_the_target_as_draft_accepts_every_proposal(
        models, monkeypatch):
    """draft == target: every proposal agrees, so each round advances by
    gamma (13 tokens: the first, then 3 rounds of 4 verified in one
    forward each) and the output is the greedy one."""
    _, tm = models
    ids = _ids(31, 2, 6)
    widths = []
    fwd = tm._fwd

    def counted(toks, *a, **k):
        widths.append(toks.shape[1])
        return fwd(toks, *a, **k)

    monkeypatch.setattr(tm, "_fwd", counted)
    got = tm.generate_speculative(ids, tm, max_new_tokens=13, gamma=4)
    assert widths.count(4) == 3
    monkeypatch.undo()
    np.testing.assert_array_equal(
        got.numpy(), tm.generate(ids, max_new_tokens=13).numpy())
