"""The port's boundary: ``paddle_tpu_torch`` stands alone and never hides
the device or the kernel.

- importing the package (every module of it) pulls in neither ``jax`` nor
  ``paddle_tpu``, and no module of the package or ``chip_smoke.py``
  imports either, nor reads an environment variable;
- entry points default to the card: without CUDA they raise unless the
  caller asks for the CPU by name;
- a kernel wrapper given a CUDA tensor launches its kernel or raises: when
  the kernel library cannot be had it raises, without running the plain
  version and without counting a launch. A stub stands in for the CUDA
  tensor, so no card is needed. That holds for the serving kernels and for
  every flash-attention entry, forward and backward, the flash dispatch
  itself, and the AdamW update;
- the training entry points (``LlamaForCausalLM``, ``TrainStep``) default
  to the card too.
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
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.jit_api import TrainStep
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import adamw as tadamw
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

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


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_reads_no_environment_variable(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    reads = [n.lineno for n in ast.walk(tree)
             if isinstance(n, ast.Attribute)
             and n.attr in ("environ", "getenv", "environb")]
    assert reads == []


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
    monkeypatch.setattr(tadamw, "_adamw_math", plain_forbidden)


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


def test_adamw_wrapper_raises_without_its_kernel(library_missing):
    n = tadamw.adamw_update.launches
    p = _CudaStub(4, 8)
    with pytest.raises(_build.KernelBuildError, match="adamw"):
        tadamw.adamw_update(p, p, p, p, lr=1e-4, beta1=0.9, beta2=0.999,
                            eps=1e-8, step=1)
    assert tadamw.adamw_update.launches == n


def test_build_raises_when_nvcc_is_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(["paged_attention"])
    assert not any(tmp_path.glob("*.so"))
