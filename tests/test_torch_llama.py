"""Port parity: the port's LLaMA against the JAX reference on the CPU.

- ``load_paddle_tpu_state`` carries every reference parameter into the
  port (Linear weights transposed from the reference's [in, out]) and
  refuses a missing, an unknown or a misshapen one;
- one decoder layer's ragged forward — the engine's packed mixed pass —
  matches the reference ``model.llama.functional_call`` with a
  ``RaggedLayerCache``: hidden states within 1e-4 (f32; the projections'
  summation order differs between the frameworks). In the pools after the
  write, outside scratch page 0, the same (page, offset) slots change and
  every other slot keeps its bits; the written K/V agree within 1e-6, as
  each framework computes them with its own projection (last-bit
  differences). The write's placement alone is held bit for bit in
  test_torch_ops.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.ops.ragged_paged_attention import RaggedLayerCache as JaxRC
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.ops.ragged_paged_attention import RaggedLayerCache


def _jax_model(layers, seed=23, **kw):
    paddle.seed(seed)
    m = JaxLlama(jax_tiny(num_hidden_layers=layers, **kw))
    m.eval()
    return m


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _port(arrays, layers, **kw):
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=layers, **kw),
                             device="cpu")
    return load_paddle_tpu_state(model, arrays)


def test_load_maps_every_parameter():
    arrays = _arrays(_jax_model(2))
    model = _port(arrays, 2)
    params = dict(model.named_parameters())
    assert set(params) == set(arrays)
    for name, a in arrays.items():
        want = a.T if name.endswith("_proj.weight") or name == \
            "lm_head.weight" else a
        np.testing.assert_array_equal(params[name].detach().numpy(), want)


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_load_refuses_bad_names_and_shapes(fault):
    arrays = _arrays(_jax_model(1))
    if fault == "extra":
        arrays["llama.layers.1.mlp.up_proj.weight"] = np.zeros((64, 128))
    elif fault == "missing":
        del arrays["llama.norm.weight"]
    else:
        arrays["lm_head.weight"] = arrays["lm_head.weight"].T
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_paddle_tpu_state(model, arrays)
    for n, p in model.named_parameters():   # nothing was written
        assert torch.equal(p, before[n])


def _packed_step(rng, vocab, pps, bs, S=3):
    """One mixed dispatch's packed stream: row 0 decodes at position 5,
    row 1 streams a 7-token prompt chunk at positions 3..9 (crossing a page
    edge), row 2 is empty; 3 pad tokens."""
    T = 11
    toks = np.zeros(T, np.int32)
    row_of = np.zeros(T, np.int32)
    token_pos = np.zeros(T, np.int32)
    valid = np.zeros(T, bool)
    toks[:8] = rng.randint(1, vocab, 8)
    row_of[1:8] = 1
    token_pos[0] = 5
    token_pos[1:8] = np.arange(3, 10)
    valid[:8] = True
    q_lens = np.array([1, 7, 0], np.int32)
    lengths = np.array([5, 3, 0], np.int32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    pt = np.zeros((S, pps), np.int32)
    pt[0] = [1, 2, 3]
    pt[1] = [4, 5, 6]
    return toks, row_of, token_pos, valid, lengths + q_lens, cu, pt


def test_one_layer_ragged_forward_matches_reference():
    jm = _jax_model(1)
    tm = _port(_arrays(jm), 1)
    cfg = tm.config
    rng = np.random.RandomState(6)
    P, bs, pps = 8, 4, 3
    shape = (cfg.num_key_value_heads, P, bs, cfg.head_dim)
    kp = rng.randn(*shape).astype(np.float32)   # earlier tokens' K/V
    vp = rng.randn(*shape).astype(np.float32)
    toks, row_of, token_pos, valid, kv_lens, cu, pt = _packed_step(
        rng, cfg.vocab_size, pps, bs)

    j = [jnp.asarray(a) for a in (kv_lens, cu, row_of, token_pos, valid)]
    jcache = JaxRC(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt), *j)
    state = jm.raw_state_dict()
    overrides = {k[len("llama."):]: Tensor(v, stop_gradient=True)
                 for k, v in state.items() if k.startswith("llama.")}
    jh, jpres = jm.llama.functional_call(
        overrides, Tensor(jnp.asarray(toks)[None]),
        position_ids=Tensor(jnp.asarray(token_pos)[None]),
        past_key_values=[jcache], use_cache=True, training=False)

    t = [torch.from_numpy(a.copy()) for a in (kv_lens, cu, row_of,
                                              token_pos, valid)]
    tcache = RaggedLayerCache(torch.from_numpy(kp.copy()),
                              torch.from_numpy(vp.copy()),
                              torch.from_numpy(pt.copy()), *t)
    with torch.no_grad():
        th, tpres = tm.llama(torch.from_numpy(toks)[None],
                             position_ids=t[3][None],
                             past_key_values=[tcache])
    n = int(cu[-1])
    np.testing.assert_allclose(th[0, :n].numpy(),
                               np.asarray(jh._data)[0, :n],
                               rtol=1e-4, atol=1e-4)
    for old, got, want in ((kp, tpres[0].k_pages, jpres[0].k_pages),
                           (vp, tpres[0].v_pages, jpres[0].v_pages)):
        old, got, want = old[:, 1:], got.numpy()[:, 1:], np.asarray(want)[:, 1:]
        slot_changed = (want != old).any(axis=(0, 3))
        assert slot_changed.sum() == n          # one slot per valid token
        np.testing.assert_array_equal((got != old).any(axis=(0, 3)),
                                      slot_changed)
        np.testing.assert_array_equal(got[:, ~slot_changed],
                                      old[:, ~slot_changed])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
