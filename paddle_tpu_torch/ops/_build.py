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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LIBS = {}
_LOCK = threading.Lock()


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
    KernelBuildError naming each source nvcc refused."""
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
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
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
    KernelBuildError when it cannot be built."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build([name])[name]["path"])
        return lib


def entry(name, symbol, argtypes):
    """C entry ``symbol`` of ``lib<name>`` with its ctypes signature set
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# dtype codes of the C entries (attention_common.cuh: ptt::DType)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def check(ok, kernel, what):
    """Raise ValueError for an operand the kernel does not take."""
    if not ok:
        raise ValueError(f"{kernel}: {what}")


def check_status(rc, kernel):
    """Raise when the launch reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
