"""Build and load the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` compiles with nvcc into its own
shared library with a plain C interface, ``build/lib<name>.so``, at
first use, and is loaded with ctypes.  Pointers are passed as
``c_void_p`` (``tensor.data_ptr()``) and the stream as
``torch.cuda.current_stream().cuda_stream``; every C entry returns
``cudaGetLastError()`` and :func:`check` raises on a non-zero code.
A failed build raises: nothing falls back.

The build directory is ``build/`` beside the package (listed in
``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> str:
    d = os.path.join(os.path.dirname(_PKG), "build")
    os.makedirs(d, exist_ok=True)
    return d


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _sources_tag(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def compile_kernel(name: str, verbose: bool = False) -> tuple[str, str]:
    """nvcc csrc/<name>.cu -> build/lib<name>-<tag>.so.  Returns the
    library path and the compiler's report (``-Xptxas -v`` output when
    ``verbose``).  Raises RuntimeError on failure."""
    out = os.path.join(build_dir(), f"lib{name}-{_sources_tag(name)}.so")
    if os.path.exists(out) and not verbose:
        return out, ""
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use);
    ``declare(lib)`` sets the argtypes of its entries."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = compile_kernel(name)
            lib = ctypes.CDLL(path)
            declare(lib)
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def check_aligned(what: str, *tensors) -> None:
    """The kernels load 16 bytes at a time: raise on a tensor whose data
    does not start on a 16-byte boundary (a view at an odd offset)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor data not 16-byte aligned")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
