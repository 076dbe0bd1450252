"""The port's boundary: ``paddle_tpu_torch`` stands alone and never hides
the device or the kernel.

- importing the package (every module of it; and the serving control
  plane's packages, ``serving`` and ``observability``, alone) pulls in
  neither ``jax`` nor ``paddle_tpu``, and no module of the package or
  ``chip_smoke.py`` imports either, nor reads an environment variable:
  only ``utils/envs.py`` reads one, for the dynamics telemetry's
  ``PADDLE_DYNAMICS*`` switches, the non-finite guard's two variables,
  the LoRA plane's three sizes and the serving control plane's own
  reference names, so no variable picks a kernel, its plain version or a
  dispatch plane (``chip_smoke.py`` may set the dynamics' switches);
- entry points (the model, the engine, the Predictor) default to the
  card: without CUDA they raise unless the caller asks for the CPU by
  name;
- a kernel wrapper given a CUDA tensor launches its kernel or raises: when
  the kernel library cannot be had it raises, without running the plain
  version and without counting a launch. A stub stands in for the CUDA
  tensor, so no card is needed. That holds for the serving kernels (their
  int8-pool variants too) and for every flash-attention entry, forward and
  backward, the flash dispatch itself, K3's segment-masked entries and the
  packed dispatch, K6's ring visit and the ring's backward dispatch, the
  AdamW update (its plain and its general, master-weight instance) and
  the gradient-norm kernel, and the MoE dispatch and combine (kernels D
  and E, forward and backward); a K/V pool pair of one int8 and one float
  pool is refused;
- the training entry points (``LlamaForCausalLM``, ``TrainStep``,
  ``DistributedTrainStep`` and its default mesh) default to the card too,
  and so do the loss scaler's and the dynamics' device state.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import device
from paddle_tpu_torch.inference import Predictor, create_predictor
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import adamw as tadamw
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import grad_norm as tgn
from paddle_tpu_torch.ops import moe_dispatch as tmd
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.ops import ring_attention as tra
from paddle_tpu_torch.ops.quantization import QuantizedTensor

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(paddle_tpu_torch.__file__).parent
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "paddle_tpu")


def test_import_leaves_jax_and_reference_out():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            f"print(json.dumps([m for m in {FORBIDDEN!r} "
            "if m in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


@pytest.mark.parametrize("package", ["paddle_tpu_torch.serving",
                                     "paddle_tpu_torch.observability",
                                     "paddle_tpu_torch.testing.chaos"])
def test_control_plane_imports_leave_jax_and_reference_out(package):
    """The serving control plane and the observability it reads (every
    module the frontend imports) stand alone: importing either package in
    a fresh interpreter loads neither ``jax`` nor ``paddle_tpu``."""
    code = (f"import importlib, json, sys\n"
            f"importlib.import_module({package!r})\n"
            f"print(json.dumps([m for m in {FORBIDDEN!r} "
            "if m in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(m, line) for m, line in _imported_roots(tree) if m in FORBIDDEN]
    assert bad == []


ENV_READER = PKG / "utils" / "envs.py"


def _environment_reads(tree):
    """Lines that read the environment: any ``environ``/``getenv``
    attribute but the target of an assignment or a ``del``."""
    writes = {id(n.value) for n in ast.walk(tree)
              if isinstance(n, ast.Subscript)
              and isinstance(n.ctx, (ast.Store, ast.Del))}
    return [n.lineno for n in ast.walk(tree)
            if isinstance(n, ast.Attribute)
            and n.attr in ("environ", "getenv", "environb")
            and id(n) not in writes]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_reads_no_environment_variable(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    if path == ENV_READER:
        return
    assert _environment_reads(tree) == []
    if path.parent == ROOT:       # chip_smoke.py sets the telemetry's
        writes = [n.slice.value for n in ast.walk(tree)
                  if isinstance(n, ast.Subscript)
                  and isinstance(n.ctx, (ast.Store, ast.Del))
                  and getattr(n.value, "attr", None) == "environ"]
        assert all(w.startswith("PADDLE_DYNAMICS") for w in writes), writes
    else:                         # the package writes none
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                    and n.attr in ("environ", "putenv", "unsetenv")]


def test_only_the_dynamics_reads_the_environment():
    """The env readers are called from ``observability/dynamics.py``, with
    its ``PADDLE_DYNAMICS*`` names, from ``jit_api.py`` for the
    non-finite guard's two variables, the reference's
    ``PADDLE_NONFINITE_TOLERANCE`` and ``PADDLE_NONFINITE_CHECK_EVERY``,
    from the LoRA plane for the reference's three ``PADDLE_LORA_*``
    sizes (``inference/continuous.py``: the adapters a decode group holds;
    ``serving/adapters.py``: the registry's byte bounds), and from the
    serving control plane's modules for the reference's own names of
    them (chaos arming, telemetry, devprof, the compile ledger's bounds,
    the handoff and wire transports, the KV fabric, tenancy, the
    disaggregation switch; each name also read in ``paddle_tpu/``), and
    from nowhere else: no variable picks a kernel or a dispatch plane."""
    from paddle_tpu_torch import jit_api
    from paddle_tpu_torch.inference import continuous
    from paddle_tpu_torch.observability import dynamics
    from paddle_tpu_torch.serving import adapters

    readers = {"env_int", "env_float", "env_bool", "env_str"}
    callers = set()
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        if any(isinstance(n, ast.Call)
               and getattr(n.func, "id", None) in readers
               for n in ast.walk(tree)):
            callers.add(path.relative_to(PKG).as_posix())
    control_plane = {
        "testing/chaos.py", "observability/tracing.py",
        "observability/compilemem.py", "observability/devprof.py",
        "serving/handoff.py", "serving/transport.py", "serving/kvfabric.py",
        "serving/tenancy.py", "serving/frontend.py"}
    assert callers == {"observability/dynamics.py", "jit_api.py",
                       "inference/continuous.py",
                       "serving/adapters.py"} | control_plane
    reference = "".join(p.read_text()
                        for p in (ROOT / "paddle_tpu").rglob("*.py"))
    for rel in sorted(control_plane):
        src = (PKG / rel).read_text()
        for node in ast.walk(ast.parse(src)):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) in readers
                    and node.args
                    and isinstance(node.args[0], ast.Constant)):
                name = node.args[0].value
                assert f'"{name}"' in reference, (rel, name)
                assert name not in ("PADDLE_SERVING_RAGGED",), (rel, name)
    names = [v for k, v in vars(dynamics).items() if k.endswith("_ENV")]
    assert len(names) == 6
    assert all(n.startswith("PADDLE_DYNAMICS") for n in names)
    guard = sorted(v for k, v in vars(jit_api).items() if k.endswith("_ENV"))
    assert guard == ["PADDLE_NONFINITE_CHECK_EVERY",
                     "PADDLE_NONFINITE_TOLERANCE"]
    lora = sorted(v for mod in (continuous, adapters)
                  for k, v in vars(mod).items() if k.endswith("_ENV"))
    assert lora == ["PADDLE_LORA_CACHE_MB", "PADDLE_LORA_MAX_MB",
                    "PADDLE_LORA_SLOTS"]
    # the engine reads no other name (the reference's
    # PADDLE_SERVING_RAGGED would pick the attention kernel)
    src = (PKG / "inference" / "continuous.py").read_text()
    assert "PADDLE_SERVING_RAGGED" not in src
    assert [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Call)
            and getattr(n.func, "id", None) in readers
            and not (isinstance(n.args[0], ast.Name)
                     and n.args[0].id == "LORA_SLOTS_ENV")] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_refuses_cuda_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve("cuda:0")
    assert device.resolve("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(llama_tiny(num_hidden_layers=1))
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(model, max_seqs=2, max_len=64)
    eng = ContinuousBatchingEngine(model, max_seqs=2, max_len=64,
                                   device="cpu")
    out = eng.serve([np.arange(1, 6, dtype=np.int32)], max_new_tokens=2)
    assert len(out[0]) == 7
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_predictor(model)
    pred = Predictor(model, device="cpu")
    assert pred.run([np.arange(1, 6, dtype=np.int32)[None]])[0].shape == (
        1, 5, 128)


class _CudaStub:
    """Stands in for a CUDA tensor: the wrappers pick their tier from
    ``.device`` before touching anything else."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device("cuda", 0)


@pytest.fixture
def library_missing(monkeypatch):
    def missing(name):
        raise _build.KernelBuildError(f"lib{name} is not built here")

    def plain_forbidden(*a, **k):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(_build, "library", missing)
    monkeypatch.setattr(trpa, "_ragged_math", plain_forbidden)
    monkeypatch.setattr(tpa, "_paged_math", plain_forbidden)
    monkeypatch.setattr(tfa, "_attention_math", plain_forbidden)
    monkeypatch.setattr(tfa, "_segment_math", plain_forbidden)
    monkeypatch.setattr(tfa, "_visit_math", plain_forbidden)
    monkeypatch.setattr(tfa, "_ring_merge_math", plain_forbidden)
    monkeypatch.setattr(tra, "_visit_bwd_math", plain_forbidden)
    monkeypatch.setattr(tadamw, "_adamw_math", plain_forbidden)
    monkeypatch.setattr(tadamw, "_adamw_plain", plain_forbidden)
    monkeypatch.setattr(tgn, "_sumsq_math", plain_forbidden)
    monkeypatch.setattr(tmd, "_dispatch_math", plain_forbidden)
    monkeypatch.setattr(tmd, "_combine_math", plain_forbidden)


def test_ragged_wrapper_raises_without_its_kernel(library_missing):
    n = trpa.ragged_paged_attention.launches
    q = _CudaStub(8, 4, 16)
    with pytest.raises(_build.KernelBuildError, match="ragged_paged"):
        trpa.ragged_paged_attention(q, None, None, None, None, None)
    assert trpa.ragged_paged_attention.launches == n


def test_paged_wrapper_raises_without_its_kernel(library_missing):
    n = tpa.paged_decode_attention.launches
    q = _CudaStub(2, 4, 16)
    with pytest.raises(_build.KernelBuildError, match="paged_attention"):
        tpa.paged_decode_attention(q, None, None, None, None)
    assert tpa.paged_decode_attention.launches == n


INT8_CALLS = {
    "ragged_paged_attention": lambda q, p: trpa.ragged_paged_attention(
        q, p, p, None, None, None),
    "paged_decode_attention": lambda q, p: tpa.paged_decode_attention(
        q, p, p, None, None),
}


@pytest.mark.parametrize("entry", sorted(INT8_CALLS))
def test_int8_wrappers_raise_without_their_kernels(library_missing, entry):
    wrapper = (trpa.ragged_paged_attention if entry.startswith("ragged")
               else tpa.paged_decode_attention)
    before = (wrapper.launches, wrapper.launches_int8)
    pool = QuantizedTensor(_CudaStub(2, 5, 16, 16), _CudaStub(2, 5, 16, 1))
    with pytest.raises(_build.KernelBuildError,
                       match=entry.replace("_decode", "")):
        INT8_CALLS[entry](_CudaStub(4, 4, 16), pool)
    assert (wrapper.launches, wrapper.launches_int8) == before


def test_kernels_refuse_a_mixed_int8_and_float_pool_pair():
    q = torch.zeros(4, 4, 16)
    codes = torch.zeros(2, 5, 16, 16, dtype=torch.int8)
    int8 = QuantizedTensor(codes, torch.ones(2, 5, 16, 1))
    with pytest.raises(ValueError, match="both be int8 or both float"):
        _build.pool_operands("k", q, int8, torch.zeros(2, 5, 16, 16))
    with pytest.raises(ValueError, match="both be int8 or both float"):
        _build.pool_operands("k", q, torch.zeros(2, 5, 16, 16), int8)
    bad_scales = QuantizedTensor(codes, torch.ones(2, 5, 16, 1,
                                                   dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="float32 scales"):
        _build.pool_operands("k", q, bad_scales, bad_scales)


def test_training_entry_points_default_to_the_card(no_cuda):
    cfg = llama_tiny(num_hidden_layers=1, fuse_linear_cross_entropy=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    opt = AdamW(parameters=model.parameters())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainStep(model, LlamaPretrainingCriterion(cfg), opt)
    step = TrainStep(model, LlamaPretrainingCriterion(cfg), opt,
                     device="cpu")
    ids = np.arange(1, 10, dtype=np.int32)[None]
    assert torch.isfinite(step(ids[:, :-1], ids[:, 1:]))


FLASH_CALLS = {
    "flash_fwd": lambda s: tfa.flash_fwd(s, s, s, True, 1.0),
    "flash_bwd_delta": lambda s: tfa.flash_bwd_delta(s, s),
    "flash_bwd_dkdv": lambda s: tfa.flash_bwd_dkdv(s, s, s, s, s, s, True,
                                                   1.0),
    "flash_bwd_dq": lambda s: tfa.flash_bwd_dq(s, s, s, s, s, s, True, 1.0),
}


@pytest.mark.parametrize("entry", sorted(FLASH_CALLS))
def test_flash_wrappers_raise_without_their_kernels(library_missing, entry):
    before = [k.launches for k in tfa.KERNELS]
    with pytest.raises(_build.KernelBuildError, match="flash_attention"):
        FLASH_CALLS[entry](_CudaStub(2, 64, 4, 64))
    assert [k.launches for k in tfa.KERNELS] == before


def test_flash_dispatch_raises_without_its_kernel(library_missing):
    before = [k.launches for k in tfa.KERNELS]
    q = _CudaStub(2, 64, 4, 64)
    with pytest.raises(_build.KernelBuildError, match="flash_attention_fwd"):
        tfa.flash_attention_fwd(q, q, q, causal=True)
    assert [k.launches for k in tfa.KERNELS] == before


SEG_CALLS = {
    "seg_flash_fwd": lambda s: tfa.seg_flash_fwd(s, s, s, None, None, True,
                                                 1.0),
    "seg_flash_bwd_delta": lambda s: tfa.seg_flash_bwd_delta(s, s),
    "seg_flash_bwd_dkdv": lambda s: tfa.seg_flash_bwd_dkdv(
        s, s, s, s, s, s, None, None, True, 1.0),
    "seg_flash_bwd_dq": lambda s: tfa.seg_flash_bwd_dq(
        s, s, s, s, s, s, None, None, True, 1.0),
}


def _all_flash_launches():
    return [k.launches for k in tfa.KERNELS + tfa.SEG_KERNELS]


@pytest.mark.parametrize("entry", sorted(SEG_CALLS))
def test_segment_flash_wrappers_raise_without_their_kernels(library_missing,
                                                            entry):
    before = _all_flash_launches()
    with pytest.raises(_build.KernelBuildError, match="flash_attention"):
        SEG_CALLS[entry](_CudaStub(2, 64, 4, 64))
    assert _all_flash_launches() == before


def test_packed_dispatch_raises_without_its_kernel(library_missing):
    before = _all_flash_launches()
    q = _CudaStub(2, 64, 4, 64)
    seg = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(_build.KernelBuildError, match="flash_attention_fwd"):
        tfa.flash_attention_packed(q, q, q, seg)
    assert _all_flash_launches() == before


def test_adamw_wrapper_raises_without_its_kernel(library_missing):
    n = tadamw.adamw_update.launches
    p = _CudaStub(4, 8)
    with pytest.raises(_build.KernelBuildError, match="adamw"):
        tadamw.adamw_update(p, p, p, p, lr=1e-4, beta1=0.9, beta2=0.999,
                            eps=1e-8, step=1)
    assert tadamw.adamw_update.launches == n


def test_adamw_master_instance_raises_without_its_kernel(library_missing):
    n = tadamw.adamw_update.launches
    p = _CudaStub(4, 8)
    with pytest.raises(_build.KernelBuildError, match="adamw"):
        tadamw.adamw_update(p, p, p, p, lr=1e-4, beta1=0.9, beta2=0.95,
                            eps=1e-5, step=1, master=p, scale=p,
                            grad_factor=p)
    assert tadamw.adamw_update.launches == n


def test_grad_norm_wrapper_raises_without_its_kernel(library_missing):
    n = tgn.grad_sumsq.launches
    g = _CudaStub(4, 8)
    with pytest.raises(_build.KernelBuildError, match="grad_norm"):
        tgn.grad_sumsq([g, g], clip_norm=1.0)
    assert tgn.grad_sumsq.launches == n


def test_build_raises_when_nvcc_is_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(["paged_attention"])
    assert not any(tmp_path.glob("*.so"))


RING_CALLS = {
    "ring_flash_fwd": lambda s: tfa.ring_flash_fwd(s, s, s, s, s, True, 1.0),
    "ring_flash_fwd_last": lambda s: tfa.ring_flash_fwd(
        s, s, s, None, s, False, 1.0, first=True, out=s),
    "ring_visit_bwd": lambda s: tra._visit_bwd(s, s, s, s, s, s, True, 1.0,
                                               s, s, s),
    "ring_delta": lambda s: tra._delta(s, s),
}


@pytest.mark.parametrize("entry", sorted(RING_CALLS))
def test_ring_wrappers_raise_without_their_kernels(library_missing, entry):
    before = _all_flash_launches() + [tfa.ring_flash_fwd.launches]
    with pytest.raises(_build.KernelBuildError, match="flash_attention"):
        RING_CALLS[entry](_CudaStub(2, 64, 4, 64))
    assert _all_flash_launches() + [tfa.ring_flash_fwd.launches] == before


def test_distributed_entry_points_default_to_the_card(no_cuda):
    from paddle_tpu_torch.distributed import (
        DistributedTrainStep, build_mesh, get_mesh, has_mesh,
    )

    assert not has_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mesh(sep=4, devices=["cuda:0"] * 4)
    cfg = llama_tiny(num_hidden_layers=1, context_parallel=True)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedTrainStep(model, LlamaPretrainingCriterion(cfg),
                             AdamW(parameters=model.parameters()))
    assert not has_mesh()


def _moe_routing():
    from paddle_tpu_torch.incubate.distributed.models.moe import route

    return route(torch.softmax(torch.randn(6, 4), -1), 2, 4)


MOE_CALLS = {
    "dispatch_rows": lambda s, r: tmd.dispatch_rows(s, r.dispatch_src),
    "combine_rows": lambda s, r: tmd.combine_rows(s, r.slot, r.weight),
    "combine_dw": lambda s, r: tmd.combine_dw(s, s, r.slot),
    "moe_dispatch": lambda s, r: tmd._Dispatch.apply(s, r.dispatch_src,
                                                     r.occupied_slot),
    "moe_combine": lambda s, r: tmd._Combine.apply(s, r.weight, r.slot,
                                                   r.dispatch_src),
}


@pytest.mark.parametrize("entry", sorted(MOE_CALLS))
def test_moe_wrappers_raise_without_their_kernels(library_missing, entry):
    counts = [tmd.dispatch_rows.launches, tmd.combine_rows.launches,
              tmd.combine_dw.launches]
    with pytest.raises(_build.KernelBuildError, match="moe_dispatch"):
        MOE_CALLS[entry](_CudaStub(24, 64), _moe_routing())
    assert [tmd.dispatch_rows.launches, tmd.combine_rows.launches,
            tmd.combine_dw.launches] == counts


def test_moe_public_entries_take_the_kernel_for_a_cuda_tensor(
        library_missing):
    class Rows(_CudaStub):
        def contiguous(self):
            return self

        def reshape(self, *shape):
            return self

    r = _moe_routing()
    with pytest.raises(_build.KernelBuildError, match="moe_dispatch"):
        tmd.moe_dispatch(Rows(6, 64), r)
    with pytest.raises(_build.KernelBuildError, match="moe_dispatch"):
        tmd.moe_combine(Rows(4, 4, 64), r)


def test_state_initializers_default_to_the_card(no_cuda):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.observability.dynamics import DynamicsMonitor

    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    dyn = DynamicsMonitor(dict(model.named_parameters()))
    for init in (GradScaler().init_state, dyn.init_state):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init()
        state = init("cpu")
        assert all(t.device.type == "cpu" for t in state.values()
                   if isinstance(t, torch.Tensor))
