"""Port parity: ``inference/config.py`` and ``inference/predictor.py``
against the JAX reference on the CPU, at ``llama_tiny`` sizes.

- ``create_predictor(layer).run`` (positional, and through the zero-copy
  handles) gives the reference Predictor's logits within 1e-5 (f32; the
  two differ in summation order only);
- ``generate`` and ``generate_speculative`` (a Predictor as the draft):
  token ids identical; ``serve``: token ids identical to the reference's
  engine at the ``max_len`` the reference's rounding picks, which the
  port's Predictor picks too; ``clone``;
- ``Predictor(config)`` from artifacts raises the reference's ValueError;
  ``export_aot``, ``load_aot`` and ``AotPredictor`` raise
  NotImplementedError; a layer on another device is refused;
- ``Config``'s accessors and toggles as the reference's.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.inference import (
    AotPredictor, Config, ContinuousBatchingEngine, Predictor,
    create_predictor,
)
from paddle_tpu_torch.inference import continuous
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny


def _pair(seed, layers):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(num_hidden_layers=layers,
                           max_position_embeddings=256))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=layers,
                                     max_position_embeddings=256),
                          device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(53, 2)


def _ids(seed, B, S):
    return np.random.RandomState(seed).randint(1, 128, (B, S)).astype(
        np.int32)


def test_run_matches_reference(models):
    jm, tm = models
    ids = _ids(0, 2, 12)
    want = JaxPredictor(jm).run([ids])
    pred = create_predictor(tm, device="cpu")
    got = pred.run([ids])
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    # the handle API: copy in, run, copy out
    assert pred.get_input_names() == ["x"]
    pred.get_input_handle("x").copy_from_cpu(ids)
    assert pred.run() is None
    assert pred.get_output_names() == ["out_0"]
    out = pred.get_output_handle("out_0")
    np.testing.assert_array_equal(out.copy_to_cpu(), got[0])
    assert out.shape() == [2, 12, 128]


def test_generate_and_speculative_tokens_identical(models):
    jm, tm = models
    ids = _ids(1, 2, 9)
    jp, tp = JaxPredictor(jm), Predictor(tm, device="cpu")
    want = jp.generate(ids, max_new_tokens=8)
    got = tp.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    jd, td = _pair(54, 1)
    want = jp.generate_speculative(ids, JaxPredictor(jd), max_new_tokens=8,
                                   gamma=3)
    got = tp.generate_speculative(ids, Predictor(td, device="cpu"),
                                  max_new_tokens=8, gamma=3)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, tp.generate(ids, max_new_tokens=8))


def test_serve_rounds_max_len_and_tokens_identical(models, monkeypatch):
    jm, tm = models
    prompts = [_ids(2, 1, n)[0] for n in (5, 37, 20)]
    made = []
    init = ContinuousBatchingEngine.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(continuous.ContinuousBatchingEngine, "__init__", spy)
    pred = Predictor(tm, device="cpu")
    got = pred.serve(prompts, max_new_tokens=6, page_size=16)
    # max(bucket of the longest, longest + new) rounded to whole pages
    assert made[0].max_len == 64 and made[0].page_size == 16
    want = JaxEngine(jm, max_seqs=4, page_size=16, max_len=64,
                     async_decode=False).serve(prompts, 6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # a warm engine is reused, the keywords pass through
    again = pred.serve(prompts, max_new_tokens=6, engine=made[0])
    for a, g in zip(again, got):
        np.testing.assert_array_equal(a, g)
    clone = pred.clone()
    assert clone._layer is tm and clone.device == pred.device
    assert clone.get_input_names() == pred.get_input_names()


def test_artifact_aot_and_device_refusals(models):
    jm, tm = models
    with pytest.raises(ValueError) as want:
        JaxPredictor(JaxConfig("model_dir"))
    with pytest.raises(ValueError) as got:
        create_predictor(Config("model_dir"))
    assert str(got.value) == str(want.value)
    pred = Predictor(tm, device="cpu")
    for call in (lambda: pred.export_aot("x.bin", _ids(0, 1, 4)),
                 lambda: Predictor.load_aot("x.bin"),
                 lambda: AotPredictor(None)):
        with pytest.raises(NotImplementedError, match="§1 item 8"):
            call()
    with pytest.raises(ValueError, match="move the layer first"):
        Predictor(tm, device="meta")


def test_config_matches_reference():
    for args in (("model_dir",), ("prog", "params"),
                 (None, None, "dir2")):
        got, want = Config(*args), JaxConfig(*args)
        assert (got.model_dir(), got.prog_file(), got.params_file()) == (
            want.model_dir(), want.prog_file(), want.params_file())
    got, want = Config("a"), JaxConfig("a")
    for c in (got, want):
        c.set_model("p", "q")
        c.disable_gpu()
        c.enable_tensorrt_engine(precision_mode="Bfloat16")
    assert (got.prog_file(), got.params_file(), got.use_gpu(),
            got._precision, got.tensorrt_engine_enabled()) == (
        want.prog_file(), want.params_file(), want.use_gpu(),
        want._precision, want.tensorrt_engine_enabled())
    got.enable_use_gpu()
    assert got.use_gpu() and got.gpu_device_id() == 0
    assert "backend=torch/cuda" in got.summary()
