"""Port parity: the flag registry (``framework.flags``), the dtype names
(``framework.dtype``) and ``amp.debugging`` against the JAX package on the
CPU.

- ``set_flags``/``get_flags``: the same values with and without the
  ``FLAGS_`` prefix, strings converted to the flag's type, an unknown name
  stored by ``set_flags`` and refused by ``get_flags`` (ValueError) in
  both; a ``FLAGS_<name>`` environment default read at import, in a fresh
  interpreter for each package;
- ``check_numerics``: the (NaN, Inf, zero) counts equal the reference's
  on the same arrays (fp16, bf16 and f32), and both raise
  FloatingPointError under CHECK_NAN_INF_AND_ABORT;
- the per-op check behind ``FLAGS_check_nan_inf``: at level 0 the first op
  whose output holds a NaN or an Inf raises FloatingPointError naming the
  op and the output, as the reference's does; at level 1 it warns; a
  kernel wrapper is one op (its output is checked where it returns, under
  its name, and nothing inside it is); the flag set by the environment
  installs the check at import;
- ``TrainStep`` and the engine's ``serve`` run unchecked, as the
  reference's compiled programs do: an overflowing loss-scaled step skips
  under the flag as without it, and the served tokens are the same.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.framework import flags as jflags
import paddle_tpu_torch
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import nan_inf
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.optimizer import AdamW

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def check_off():
    """Leave the flags as the test found them (the check off)."""
    before = tflags.get_flags(["check_nan_inf", "check_nan_inf_level"])
    jbefore = jflags.get_flags(["check_nan_inf", "check_nan_inf_level"])
    yield
    tflags.set_flags(before)
    jflags.set_flags(jbefore)
    assert not nan_inf.active()


def test_flag_registry_matches_reference(check_off):
    for pkg in (jflags, tflags):
        pkg.set_flags({"FLAGS_call_stack_level": "3", "v": 2.0,
                       "enable_profiler": "true", "my_custom_flag": 7})
    names = ["call_stack_level", "FLAGS_v", "enable_profiler",
             "FLAGS_my_custom_flag", "distributed_timeout_s",
             "fraction_of_gpu_memory_to_use", "allocator_strategy"]
    assert tflags.get_flags(names) == jflags.get_flags(names)
    assert tflags.get_flags("FLAGS_v") == {"FLAGS_v": 2}
    assert paddle_tpu_torch.get_flags("v") == jflags.get_flags("v")
    for pkg in (jflags, tflags):
        with pytest.raises(ValueError, match="unknown flag"):
            pkg.get_flags(["v", "FLAGS_no_such_flag"])
        pkg.set_flags({"call_stack_level": 2, "v": 0,
                       "enable_profiler": False})


def _flags_in_fresh_interpreter(package, env):
    code = (f"import json, {package} as p\n"
            "print(json.dumps(p.get_flags(['v', 'use_tf32', "
            "'fraction_of_gpu_memory_to_use', 'allocator_strategy'])))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, **env})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_environment_defaults_match_reference():
    env = {"FLAGS_v": "4", "FLAGS_use_tf32": "0",
           "FLAGS_fraction_of_gpu_memory_to_use": "0.5",
           "FLAGS_allocator_strategy": "naive_best_fit"}
    want = _flags_in_fresh_interpreter("paddle_tpu", env)
    assert want["FLAGS_v"] == 4 and want["FLAGS_use_tf32"] is False
    assert _flags_in_fresh_interpreter("paddle_tpu_torch", env) == want


def test_environment_flag_installs_the_check_at_import():
    code = ("import torch, paddle_tpu_torch\n"
            "try:\n"
            "    torch.log(torch.zeros(3))\n"
            "except FloatingPointError as e:\n"
            "    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "FLAGS_check_nan_inf": "1"})
    assert out.returncode == 0, out.stderr
    assert "raised Operator aten.log.default output 0 contains 3" in (
        out.stdout)


def test_dtype_names_and_info():
    assert paddle_tpu_torch.float16 is torch.float16
    assert paddle_tpu_torch.bfloat16 is torch.bfloat16
    assert paddle_tpu_torch.get_default_dtype() == torch.float32
    for name in ("float16", "bfloat16", "float32"):
        want = paddle.finfo(name)
        got = paddle_tpu_torch.finfo(name)
        assert (float(got.eps), float(got.max), got.bits) == (
            float(want.eps), float(want.max), want.bits)
    for name in ("int8", "int32", "int64", "uint8"):
        want, got = paddle.iinfo(name), paddle_tpu_torch.iinfo(name)
        assert (got.min, got.max, got.bits) == (want.min, want.max,
                                                 want.bits)
    paddle_tpu_torch.set_default_dtype("float16")
    try:
        assert paddle_tpu_torch.get_default_dtype() == torch.float16
    finally:
        paddle_tpu_torch.set_default_dtype("float32")


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_check_numerics_matches_reference(dtype):
    a = np.array([[0.0, 1.0, np.nan, -np.inf], [0.0, np.inf, 2.0, 0.0]],
                 np.float32)
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    mode = jdbg.DebugMode.CHECK_NAN_INF
    want = [int(np.asarray(x._data)) for x in jdbg.check_numerics(
        j, debug_mode=mode)]
    got = tdbg.check_numerics(t, debug_mode=tdbg.DebugMode.CHECK_NAN_INF)
    assert [int(x) for x in got] == want == [1, 2, 3]
    for pkg, x in ((jdbg, j), (tdbg, t)):
        with pytest.raises(FloatingPointError, match="op=matmul var=out"):
            pkg.check_numerics(x, "matmul", "out")


def test_per_op_check_raises_then_warns(check_off):
    x = np.ones(4, np.float32)
    for pkg in (jflags, tflags):
        pkg.set_flags({"check_nan_inf": True})
    assert nan_inf.active()
    with pytest.raises(FloatingPointError, match="output 0 contains 4"):
        paddle.log(paddle.to_tensor(x) - 1.0)
    with pytest.raises(FloatingPointError,
                       match="Operator aten.log.default output 0 contains 4"):
        torch.log(torch.from_numpy(x) - 1.0)
    tdbg.enable_operator_stats_collection()         # level 1: warn
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y = torch.log(torch.from_numpy(x) - 1.0) * 2.0
    assert torch.isinf(y).all()
    assert [str(w.message).split(" output")[0] for w in caught] == [
        "Operator aten.log.default", "Operator aten.mul.Tensor"]
    tdbg.disable_operator_stats_collection()
    assert not nan_inf.active()
    with tdbg.collect_operator_numerical_stats():
        assert nan_inf.active()
    assert not nan_inf.active()


def test_kernel_wrapper_is_one_checked_op(check_off):
    g = torch.Generator().manual_seed(0)
    kp = torch.randn(2, 5, 16, 16, generator=g)
    vp = torch.randn(2, 5, 16, 16, generator=g)
    vp[1, 1, 3, 0] = float("inf")        # a planted inf value
    q = torch.randn(2, 4, 16, generator=g)
    args = (q, kp, vp, torch.tensor([5, 20], dtype=torch.int32),
            torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
    tflags.set_flags({"check_nan_inf": True, "check_nan_inf_level": 1})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = tpa.paged_decode_attention(*args)
    assert not torch.isfinite(out).all()
    assert [str(w.message).split(" contains")[0] for w in caught] == [
        "Operator paged_decode_attention output 0"]
    tflags.set_flags({"check_nan_inf_level": 0})
    with pytest.raises(FloatingPointError,
                       match="Operator paged_decode_attention output 0"):
        tpa.paged_decode_attention(*args)


@pytest.mark.parametrize("planted, raises", [
    ("lse", False), ("out", True)])
def test_flash_forward_checks_its_output_not_its_lse(check_off, monkeypatch,
                                                     planted, raises):
    """K3's forward returns (out, lse), lse -inf where a row sees no key (a
    varlen query whose key sequence is empty): the check reads out alone,
    as the reference's reads the op's output. The kernel runs only on the
    card, so its C entry is stood in for by one that writes the kernel's
    results through the pointers it is given: 0 everywhere, then -inf at
    lse[0] (a correct call) or inf at out[0] (a faulty one)."""
    import ctypes

    from paddle_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 64, 2, 64)
    k = v = torch.zeros(1, 64, 2, 64)
    segs = fa._varlen_segments([0, 32, 64], [0, 0, 64], 64, 64, "cpu")
    key_ranges, _ = fa._tile_ranges(segs, True)

    def fake_entry(lib, symbol, argtypes):
        def launch(q_p, k_p, v_p, out_p, lse_p, *rest):
            ctypes.memset(out_p, 0, q.numel() * 4)
            ctypes.memset(lse_p, 0, 2 * 64 * 4)
            ptr = lse_p if planted == "lse" else out_p
            ctypes.c_float.from_address(ptr).value = (
                float("-inf") if planted == "lse" else float("inf"))
            return 0
        return launch

    monkeypatch.setattr(fa._build, "entry", fake_entry)
    monkeypatch.setattr(fa, "_check_paddle_layout",
                        lambda *a, **kw: (1, 64, 64, 2, 2, 64))
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa.seg_flash_fwd, "launches", 0)
    tflags.set_flags({"check_nan_inf": True})
    if raises:
        with pytest.raises(FloatingPointError,
                           match="flash_attention_seg_fwd output 0"):
            fa.seg_flash_fwd(q, k, v, segs, key_ranges, True, 0.125)
        return
    out, lse = fa.seg_flash_fwd(q, k, v, segs, key_ranges, True, 0.125)
    tflags.set_flags({"check_nan_inf": False})
    assert torch.isfinite(out).all() and lse[0, 0, 0] == float("-inf")


def test_train_step_and_serve_run_unchecked(check_off):
    cfg = llama_tiny(num_hidden_layers=1, fuse_linear_cross_entropy=True)
    ids = np.random.RandomState(0).randint(1, 128, (2, 2, 17))

    def train(flag):
        tflags.set_flags({"check_nan_inf": flag})
        model = LlamaForCausalLM(cfg, device="cpu", seed=0)
        step = TrainStep(
            model, lambda h, w, y, m: LlamaPretrainingCriterion()(h, w, y)
            * m.reshape(()), AdamW(parameters=model.parameters()),
            n_labels=2, scaler=GradScaler(decr_every_n_nan_or_inf=1),
            device="cpu")
        out = []
        for i, b in enumerate(ids):
            mult = np.array([2.0 ** 127 if i == 0 else 1.0], np.float32)
            out.append((float(step(b[:, :-1].astype(np.int32),
                                   b[:, 1:].astype(np.int64), mult)),
                        step.last_skipped))
        prompts = [b[0] for b in ids]
        eng = ContinuousBatchingEngine(model, max_seqs=2, page_size=16,
                                       max_len=64, device="cpu")
        tokens = eng.serve(prompts, 4)
        tflags.set_flags({"check_nan_inf": False})
        return out, [t.tolist() for t in tokens]

    on, off = train(True), train(False)
    assert on == off
    assert on[0][0][1] and not on[0][1][1]
