"""Build a CUDA source of ``scae_tpu_torch/csrc`` into a shared library.

Plain ``nvcc`` for ``sm_90a`` into a ``.so`` with a C interface, loaded
with ``ctypes``: no PyTorch headers are compiled, so a build takes seconds.
Libraries go to ``scae_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, the shared headers and the flags, and are
built at the first call on a CUDA tensor, never at import. A build is written under a
temporary name and renamed into place, so concurrent builds never see a
half-written library and no lock file is needed.
"""

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin; it is needed to build the "
                       "CUDA kernels")


@dataclasses.dataclass
class BuiltLibrary:
    """Path of a built library, with the compiler's report and seconds."""

    path: str
    log: str
    seconds: float
    cached: bool    # True: an identical earlier build was reused


def _headers():
    """The shared headers of ``csrc/`` (``common.cuh``, which every source
    includes, ``decoder_ll_banded.cuh`` and ``decoder_ll_tap_bwd.cuh``),
    hashed into every build, so that a change to one rebuilds every
    kernel."""
    return sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC)
                  if n.endswith(".cuh"))


def build(source_name: str) -> BuiltLibrary:
    """Compile ``csrc/<source_name>`` unless an identical build exists."""
    src = os.path.join(CSRC, source_name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *_headers()]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source_name)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    log_path = out + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuiltLibrary(out, log, 0.0, cached=True)

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return BuiltLibrary(out, log, seconds, cached=False)


@functools.cache
def load(source_name: str, symbol: str, n_ptr: int, n_int: int):
    """Build ``csrc/<source_name>`` at first use and load it with ctypes.

    Returns the launcher ``symbol``, a C function of ``n_ptr`` pointers,
    ``n_int`` ints and a stream that returns a cudaError_t; the library's
    ``scae_cuda_error_string``; and the ``BuiltLibrary`` record.
    """
    built = build(source_name)
    lib = ctypes.CDLL(built.path)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.scae_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err, built


def query(source_name: str, symbol: str, *sizes) -> int:
    """A positive count that a kernel's library reports for the current
    card: its ``symbol``, a C function of ints that returns the count or
    minus a cudaError_t (blocks that fit on one SM at these sizes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; a thread's registers,
    from cudaFuncGetAttributes). Builds the kernel if needed."""
    fn = getattr(ctypes.CDLL(build(source_name).path), symbol)
    fn.argtypes = [ctypes.c_int] * len(sizes)
    fn.restype = ctypes.c_int
    count = fn(*(int(a) for a in sizes))
    if count <= 0:
        raise RuntimeError(f"{symbol}: query failed ({count})")
    return count
