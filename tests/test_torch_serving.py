"""Port parity: the port's ragged continuous-batching engine serves the
same greedy token ids as the JAX reference engine (ragged, math tiers on
the CPU) on the same weights.

Five prompts of 9 to 200 tokens under a 64-token chunk budget and 16-token
pages: some prompts take several mixed dispatches, some cross page edges.
Greedy ids must be identical, with the port's ``async_decode`` on and off,
and with an EOS that fires in the middle of a decode block. Each engine is
built inside its test (the reference engine holds process-wide locks and
registries).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

LENS = (9, 200, 40, 130, 17)
ENGINE = dict(max_seqs=4, page_size=16, max_len=512, prefill_chunk=64)
NEW = 16


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=512))
    jm.eval()
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=512),
        device="cpu")
    load_paddle_tpu_state(tm, arrays)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in LENS]
    return jm, tm, prompts


@pytest.fixture(scope="module")
def reference(models):
    jm, _, prompts = models
    return JaxEngine(jm, **ENGINE).serve(prompts, max_new_tokens=NEW)


def _port_serve(tm, prompts, async_decode, **kw):
    eng = ContinuousBatchingEngine(tm, async_decode=async_decode,
                                   device="cpu", **ENGINE)
    out = eng.serve(prompts, max_new_tokens=NEW, **kw)
    assert len(eng.free_pages) == eng.num_pages - 1   # every page back
    return out


@pytest.mark.parametrize("async_decode", [True, False])
def test_greedy_tokens_identical(models, reference, async_decode):
    _, tm, prompts = models
    got = _port_serve(tm, prompts, async_decode)
    for p, w, g in zip(prompts, reference, got):
        assert len(g) == len(p) + NEW
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("async_decode", [True, False])
def test_eos_mid_block_identical(models, reference, async_decode):
    jm, tm, prompts = models
    # an eos whose first occurrence in request 0 falls inside a decode
    # block of 8 (decode_block's default), not at its end
    gen = list(reference[0][len(prompts[0]):])
    first = next(gen.index(t) for t in gen if (gen.index(t) + 1) % 8)
    eos = int(gen[first])
    want = JaxEngine(jm, **ENGINE).serve(prompts, max_new_tokens=NEW,
                                         eos_token_id=eos)
    got = _port_serve(tm, prompts, async_decode, eos_token_id=eos)
    assert len(want[0]) == len(prompts[0]) + first + 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
