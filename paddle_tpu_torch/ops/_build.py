"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes). Libraries land in ``_build/`` beside this
file, named by a hash of the sources and flags, and are built at first use;
``build()`` starts one ``nvcc`` per source, all at once.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LIBS = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    path = shutil.which("nvcc") or _DEFAULT_NVCC
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found (on PATH or at /usr/local/cuda/bin): the CUDA "
            "kernels of paddle_tpu_torch build on a machine with the CUDA "
            "toolkit")
    return path


def _lib_path(name):
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every named kernel source whose library is not built yet,
    all in parallel. Returns {name: {"path", "seconds", "log"}}; raises
    KernelBuildError naming each source nvcc refused. Each ``nvcc`` in
    flight stands in the compile ledger's breadcrumb
    (``compiling.<rank>.json``, read by the hang watchdog) as
    ``build.<name>`` with its library's file name, from its start to its
    end."""
    from ..observability.compilemem import ledger

    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": "cached"}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        tok = ledger.track(f"build.{name}", library=path.name)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except BaseException:
            ledger.untrack(tok)
            raise
        procs[name] = (proc, tmp, path, time.perf_counter(), tok)
    # each nvcc's output is drained by a thread of its own, so that a
    # source's seconds and breadcrumb end when its own nvcc does
    done = {}

    def wait(name, proc, tok):
        try:
            log, _ = proc.communicate()
        finally:
            ledger.untrack(tok)
        done[name] = (log, time.perf_counter())

    waiters = [threading.Thread(target=wait, args=(n, p[0], p[4]),
                                daemon=True) for n, p in procs.items()]
    for w in waiters:
        w.start()
    failed = []
    for w, (name, (proc, tmp, path, t0, _)) in zip(waiters, procs.items()):
        w.join()
        log, t1 = done[name]
        secs = t1 - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": secs, "log": log}
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name):
    """The loaded ``lib<name>`` (built on first use). Raises
    KernelBuildError when it cannot be built. A first build runs under the
    serving engines' process-wide compile lock (``_LOCK`` inside it), so
    the serving monitor spares a dispatcher that builds or waits for a
    build, and is recorded in the compile ledger as ``build.<name>``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    from ..inference.continuous import _COMPILE_LOCK
    from ..observability.compilemem import record_compile

    with _COMPILE_LOCK, _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with record_compile(f"build.{name}"):
                lib = _LIBS[name] = ctypes.CDLL(build([name])[name]["path"])
        return lib


def count_launch(fn, attr="launches", like=None):
    """Add one to the wrapper ``fn``'s launch count ``attr`` and to its
    count for the calling thread (``fn.launches_by_thread[(attr,
    thread ident)]``), under one lock: serving replicas launch from threads
    of their own, and a lost increment would undercount. A launch whose
    tensor ``like`` (or one of the list ``like``) is fp16 ran the kernel's
    fp16 instance and is counted in ``fn.launches_fp16`` too, so that a
    path can show which instances it ran."""
    me = threading.get_ident()
    likes = [] if like is None else (
        [like] if isinstance(like, torch.Tensor) else like)
    fp16 = any(t.dtype == torch.float16 for t in likes)
    attrs = (attr, "launches_fp16") if fp16 else (attr,)
    with _COUNT_LOCK:
        per = fn.__dict__.setdefault("launches_by_thread", {})
        for a in attrs:
            setattr(fn, a, getattr(fn, a) + 1)
            per[(a, me)] = per.get((a, me), 0) + 1


def entry(name, symbol, argtypes):
    """C entry ``symbol`` of ``lib<name>`` with its ctypes signature set
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# dtype codes of the C entries (attention_common.cuh: ptt::DType)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}


#: the codes of the kernels that have no fp16 instance yet: kernel C
#: (weight_only_linear.cu) and kernels D/E (moe_dispatch.cu), whose C
#: entries refuse any other code
NO_FP16 = ("an fp16 instance of this kernel is ROADMAP section 1 item 3's "
           "remainder")
F32_BF16_CODES = {k: v for k, v in DTYPE_CODES.items()
                  if k != "torch.float16"}


def check_dtype(kernel, t, codes=None):
    """Raise ValueError unless ``t``'s dtype has a code in ``codes`` (by
    default DTYPE_CODES: f32, bf16, fp16; ints, f64 and the rest are
    refused)."""
    codes = DTYPE_CODES if codes is None else codes
    extra = f" ({NO_FP16})" if t.dtype == torch.float16 else ""
    check(str(t.dtype) in codes, kernel,
          f"dtype {t.dtype} not in {sorted(codes)}{extra}")


def check(ok, kernel, what):
    """Raise ValueError for an operand the kernel does not take."""
    if not ok:
        raise ValueError(f"{kernel}: {what}")


def pool_operands(kernel, q, k_pages, v_pages):
    """Validate a K/V pool pair for a kernel of query ``q`` (f32, bf16 or
    fp16): both float in q's dtype, or both int8 ``QuantizedTensor``s
    (int8 codes, f32 scales ``[Hkv, P, bs, 1]``). Returns the data pointers
    in the C entry's order (k, v; or k codes, k scales, v codes, v scales)
    and the weight shape ``(Hkv, P, bs, D)``."""
    from .quantization import is_quantized

    quant = is_quantized(k_pages)
    check(quant == is_quantized(v_pages), kernel,
          "k and v pools must both be int8 or both float")
    if quant:
        tensors = (k_pages.weight, k_pages.scales, v_pages.weight,
                   v_pages.scales)
        shape = tuple(k_pages.weight.shape)
        for pool in (k_pages, v_pages):
            check(pool.weight.dtype == torch.int8
                  and pool.scales.dtype == torch.float32, kernel,
                  "an int8 pool is int8 codes with float32 scales")
            check(tuple(pool.weight.shape) == shape
                  and tuple(pool.scales.shape) == shape[:3] + (1,), kernel,
                  "int8 pools must be codes [Hkv, P, bs, D] with scales "
                  "[Hkv, P, bs, 1]")
    else:
        tensors = (k_pages, v_pages)
        shape = tuple(k_pages.shape)
        check(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype, kernel,
              "float pools must have q's dtype")
        check(tuple(v_pages.shape) == shape, kernel,
              "pools must be [Hkv, P, bs, D]")
    check(q.is_cuda, kernel, "q must be a CUDA tensor")
    check_dtype(kernel, q)
    check(len(shape) == 4, kernel, "pools must be [Hkv, P, bs, D]")
    for t in tensors:
        check(t.device == q.device, kernel, "operands must share q's device")
        check(t.is_contiguous(), kernel, "operands must be contiguous")
        check(t.data_ptr() % 16 == 0, kernel,
              "operands must be 16-byte aligned")
    return [t.data_ptr() for t in tensors], shape


def check_status(rc, kernel):
    """Raise when the launch reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
