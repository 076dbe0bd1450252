"""Port parity: per-request LoRA adapters (``serving/adapters.py`` and the
engine's adapter plane) against the JAX reference on the CPU.

- ``LoRAAdapter``: the reference's validation, and digests equal to the
  reference's for the same arrays and scale;
- ``AdapterRegistry`` (mirroring ``tests/test_lora.py``'s
  ``TestLoRAAdapter`` and ``TestAdapterRegistry``): idempotent
  registration, lookup by name, digest or object, the replace refused
  while pinned, LRU eviction of refcount-0 entries only, the per-adapter
  and whole-cache byte bounds (the two ``PADDLE_LORA_*`` variables read as
  the reference reads them), acquire/release;
- the engine: a mixed batch (two adapters of one rank, base rows) gives
  token ids identical to the JAX engine's, ragged and legacy; a
  zero-weight adapter's tokens equal the base serve's; a base-only batch
  does no LoRA work (``lora_dispatches``); a zero-slot row's logits equal
  the reference's ``base + 0.0 * delta`` bit for bit, -0.0 and NaN rows
  included; admission defers a rank mismatch, an adapter behind a base
  group and one past ``PADDLE_LORA_SLOTS`` with the reference's statuses;
  a shape mismatch fails alone with the reference's message; a short
  adapter list raises the reference's ValueError.
The reference engines run ``async_decode=False`` (ROADMAP.md §3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.inference.continuous import EngineRequest as JaxRequest
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from paddle_tpu.serving.adapters import LoRAAdapter as JaxAdapter
from paddle_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine, EngineRequest,
)
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import AdapterRegistry, LoRAAdapter

HIDDEN, VOCAB = 64, 128


def _ab(seed=0, hidden=8, r=2, vocab=16, mult=1.0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(hidden, r) * mult).astype(np.float32),
            (rng.randn(r, vocab) * mult).astype(np.float32))


# ---- the adapter and the registry ------------------------------------------
def test_adapter_validation_matches_reference():
    a, b = _ab()
    cases = [("matching r", (a, _ab(r=3)[1])),
             ("float32", (a.astype(np.float64), b)),
             ("need a", (a.reshape(-1), b)),
             ("rank must be >= 1", (np.zeros((8, 0), np.float32),
                                    np.zeros((0, 16), np.float32)))]
    for match, (aa, bb) in cases:
        with pytest.raises(ValueError, match=match) as got:
            LoRAAdapter("x", aa, bb)
        with pytest.raises(ValueError) as want:
            JaxAdapter("x", aa, bb)
        assert str(got.value) == str(want.value)


def test_digest_is_content_identity_and_the_references():
    for seed, scale in ((1, 1.0), (2, 2.5), (3, -0.5)):
        a, b = _ab(seed)
        ad = LoRAAdapter("x", a, b, scale=scale)
        assert ad.digest == JaxAdapter("y", a, b, scale=scale).digest
        assert ad.digest == LoRAAdapter("z", a, b, scale=scale).digest
        assert (ad.rank, ad.nbytes) == (2, a.nbytes + b.nbytes)
    a, b = _ab(1)
    assert (LoRAAdapter("x", a, b, scale=2.0).digest
            != LoRAAdapter("x", a, b).digest)


def test_register_idempotent_and_lookup_by_name_digest_object():
    reg = AdapterRegistry(max_bytes=1 << 20)
    a, b = _ab(1)
    ad = reg.register("tone", a, b)
    assert reg.register("tone", a, b) is ad     # identical content
    assert len(reg) == 1
    assert reg.get("tone") is ad
    assert reg.get(ad.digest) is ad
    assert reg.get(ad) is ad
    assert reg.get("ghost") is None


def test_replace_refused_while_pinned():
    reg = AdapterRegistry(max_bytes=1 << 20)
    old = reg.register("tone", *_ab(1))
    reg.acquire("tone")
    with pytest.raises(ValueError, match="held by in-flight"):
        reg.register("tone", *_ab(2))
    reg.release("tone")
    new = reg.register("tone", *_ab(2))         # idle: replace allowed
    assert new.digest != old.digest
    assert reg.get(old.digest) is None


def test_lru_evicts_refcount_zero_only():
    a, b = _ab(1)
    nbytes = a.nbytes + b.nbytes
    reg = AdapterRegistry(max_bytes=2 * nbytes)
    ad1 = reg.register("ad1", *_ab(1))
    reg.register("ad2", *_ab(2))
    reg.acquire("ad1")                          # pin the LRU-oldest
    ad3 = reg.register("ad3", *_ab(3))
    assert reg.get("ad2") is None               # the idle one went
    assert reg.get("ad1") is ad1 and reg.get("ad3") is ad3
    assert reg.nbytes == 2 * nbytes
    reg.acquire("ad3")
    with pytest.raises(ValueError, match="cache full"):
        reg.register("ad4", *_ab(4))


def test_byte_bounds_and_their_environment(monkeypatch):
    reg = AdapterRegistry(max_bytes=1 << 20, max_adapter_bytes=16)
    with pytest.raises(ValueError, match="max_adapter_bytes"):
        reg.register("monster", *_ab(1))
    monkeypatch.setenv("PADDLE_LORA_MAX_MB", "3")
    monkeypatch.setenv("PADDLE_LORA_CACHE_MB", "garbage")   # the default
    got, want = AdapterRegistry(), JaxRegistry()
    assert (got.max_adapter_bytes, got.max_bytes) == (
        want.max_adapter_bytes, want.max_bytes) == (3 << 20, 256 << 20)


def test_acquire_unknown_raises_release_idempotent():
    reg = AdapterRegistry(max_bytes=1 << 20)
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        reg.acquire("ghost")
    reg.register("tone", *_ab(1))
    reg.release("tone")                         # never pinned: no-op
    reg.release("tone")
    assert reg.refcount("tone") == 0            # no underflow
    reg.acquire("tone")
    assert reg.refcount("tone") == 1
    rep = reg.report()
    assert rep["entries"] == 1
    assert rep["adapters"][0]["inflight"] == 1


# ---- the engine -------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    paddle.seed(43)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=256))
    jm.eval()
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=256),
        device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


KW = dict(max_seqs=4, page_size=16, max_len=128, decode_block=4)
PROMPTS = [np.random.RandomState(9).randint(1, 128, n).astype(np.int32)
           for n in (5, 12, 20, 9)]


def _pair(name, seed, rank=4, scale=2.0, mult=1.0):
    a, b = _ab(seed, HIDDEN, rank, VOCAB, mult)
    return (LoRAAdapter(name, a, b, scale=scale),
            JaxAdapter(name, a, b, scale=scale))


@pytest.mark.parametrize("ragged", [True, False])
def test_mixed_batch_tokens_identical(models, ragged):
    jm, tm = models
    (ta, ja), (tb, jb) = _pair("a", 1), _pair("b", 2, scale=-1.5)
    ref = JaxEngine(jm, async_decode=False, ragged=ragged, **KW)
    eng = ContinuousBatchingEngine(tm, ragged=ragged, device="cpu", **KW)
    want = ref.serve(PROMPTS, max_new_tokens=8, adapters=[ja, None, jb, None])
    n0 = eng.lora_dispatches
    got = eng.serve(PROMPTS, max_new_tokens=8, adapters=[ta, None, tb, None])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert eng.lora_dispatches > n0
    base = eng.serve(PROMPTS, max_new_tokens=8)
    # the adapters moved their rows, and the base rows rode the zero slot
    assert not np.array_equal(got[0], base[0])
    assert not np.array_equal(got[2], base[2])
    np.testing.assert_array_equal(got[1], base[1])
    np.testing.assert_array_equal(got[3], base[3])


@pytest.mark.parametrize("ragged", [True, False])
def test_zero_adapter_equals_base_and_base_does_no_lora_work(models, ragged):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, ragged=ragged, device="cpu", **KW)
    n0 = eng.lora_dispatches
    base = eng.serve(PROMPTS, max_new_tokens=8)
    assert eng.lora_dispatches == n0            # no LoRA work at all
    zero = LoRAAdapter("zero", np.zeros((HIDDEN, 4), np.float32),
                       np.zeros((4, VOCAB), np.float32))
    for b, z in zip(base, eng.serve(PROMPTS, max_new_tokens=8,
                                    adapters=zero)):
        np.testing.assert_array_equal(z, b)
    assert eng.lora_dispatches > n0


def test_zero_slot_logits_match_reference_bit_for_bit(models, monkeypatch):
    """``_head`` on crafted base logits (exact -0.0 entries, a NaN row, a
    row of ties) and hidden rows (one NaN): a zero-slot row's logits and
    greedy token are the reference's ``base + ((h @ A) @ B) * 0``."""
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **KW)
    rng = np.random.RandomState(6)
    base = rng.randn(4, 1, VOCAB).astype(np.float32)
    base[0, 0, :10] = -0.0
    base[0, 0, 10:] = -1.0                      # the max is a -0.0 run
    base[1, 0, 3] = np.nan
    base[2, 0, :] = 0.5                          # every logit tied
    h = rng.randn(4, 1, HIDDEN).astype(np.float32)
    h[3, 0, 7] = np.nan
    a = np.stack([np.zeros((HIDDEN, 4), np.float32)] * 4)
    b = np.stack([np.zeros((4, VOCAB), np.float32)] * 4)
    a[1] = rng.randn(HIDDEN, 4)                  # a real adapter's stacks
    b[1] = rng.randn(4, VOCAB)                   # under a zero scale
    scale = np.zeros((4, 1, 1), np.float32)
    want = (jnp.asarray(base) + jnp.einsum(
        "bsr,brv->bsv", jnp.einsum("bsh,bhr->bsr", jnp.asarray(h), a), b)
        * scale)
    monkeypatch.setattr(eng.model, "head", lambda x: torch.from_numpy(base))
    got = eng._head(torch.from_numpy(h), tuple(map(torch.from_numpy,
                                                   (a, b, scale))))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(
        got[:, 0].argmax(-1).numpy(), np.asarray(jnp.argmax(want[:, 0], -1)))


def test_admission_gates_match_reference(models, monkeypatch):
    """Statuses of the same admissions on a fresh engine of each package
    (ragged admission does no device work): an adapter group takes base
    rows and adapters of its rank up to PADDLE_LORA_SLOTS distinct ones,
    and defers another rank; a base group defers adapters."""
    jm, tm = models
    (t4, j4), (t4b, j4b) = _pair("r4", 1), _pair("r4b", 3)
    t2, j2 = _pair("r2", 2, rank=2)

    def run(make, request, ads):
        out = []
        for seq in (["a", None, "c", "b"], [None, "a"]):
            eng = make()
            out.append([eng.try_admit_one(request(
                i, PROMPTS[i % 4], 4, adapter=ads.get(n)))
                for i, n in enumerate(seq)])
        return out

    def both(slots):
        monkeypatch.setenv("PADDLE_LORA_SLOTS", str(slots))
        return (run(lambda: ContinuousBatchingEngine(tm, device="cpu", **KW),
                    EngineRequest, {"a": t4, "b": t4b, "c": t2}),
                run(lambda: JaxEngine(jm, async_decode=False, **KW),
                    JaxRequest, {"a": j4, "b": j4b, "c": j2}))

    got, want = both(4)
    assert got == want == [["admitted", "admitted", "deferred", "admitted"],
                           ["admitted", "deferred"]]
    got, want = both(1)   # the group holds one adapter: "b" waits
    assert got == want == [["admitted", "admitted", "deferred", "deferred"],
                           ["admitted", "deferred"]]


def test_shape_mismatch_fails_alone_with_reference_message(models):
    jm, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **KW)
    a, b = np.zeros((HIDDEN + 1, 2), np.float32), np.zeros((2, VOCAB),
                                                            np.float32)
    res = eng.serve(PROMPTS[:2], max_new_tokens=4,
                    adapters={0: LoRAAdapter("bad", a, b)})
    assert res[0] is None and len(res[1]) == len(PROMPTS[1]) + 4
    ref = JaxEngine(jm, async_decode=False, **KW)
    want = ref._lora_reject(JaxAdapter("bad", a, b))
    assert str(eng.request_errors[0]) == str(want)
    assert "do not match model" in str(want)


def test_short_adapter_list_raises_reference_error(models):
    jm, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **KW)
    with pytest.raises(ValueError, match="per-request adapters") as got:
        eng.serve(PROMPTS, max_new_tokens=2, adapters=[None])
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, async_decode=False, **KW).serve(
            PROMPTS, max_new_tokens=2, adapters=[None])
    assert str(got.value) == str(want.value)
    assert eng.idle() and len(eng.free_pages) == eng.num_pages - 1


def test_adapter_under_prefill_chunk_follows_the_oracle(models):
    """A fault of the reference the port does not copy: on the legacy
    plane with ``prefill_chunk``, an adapter request longer than a chunk
    prefills monolithically (a 64-token bucket for 48 tokens: 4 pages)
    but reserves and scatters by the chunk ladder's region (3 pages); the
    reference's scatter clamps the fourth page's index and writes the
    bucket's pad over the prompt's last page. The port drops the pad, and
    its greedy tokens are the adapter's own: the full-context forward's
    argmax of base head + 1.5 * (h @ A) @ B at every step (tokens 2-8 of
    the reference's differ)."""
    jm, tm = models
    (ta, ja), = [_pair("chunked", 0, scale=1.5, mult=0.5)]
    prompt = np.random.RandomState(12).randint(1, 128, 48).astype(np.int32)
    kw = dict(KW, ragged=False, prefill_chunk=16)
    seq, want = list(prompt), []
    with torch.no_grad():
        for _ in range(8):
            h = tm.llama(torch.as_tensor(np.asarray(seq, np.int32))[None])
            h = h[0, -1]
            logits = tm.head(h) + (h.float() @ torch.from_numpy(ta.a)
                                   ) @ torch.from_numpy(ta.b) * ta.scale
            want.append(int(logits.argmax()))
            seq.append(want[-1])
    got = ContinuousBatchingEngine(tm, device="cpu", **kw).serve(
        [prompt], 8, adapters=ta)[0][48:]
    assert got.tolist() == want
    ref = JaxEngine(jm, async_decode=False, **kw).serve(
        [prompt], 8, adapters=ja)[0][48:]
    assert ref[0] == want[0] and ref.tolist() != want
