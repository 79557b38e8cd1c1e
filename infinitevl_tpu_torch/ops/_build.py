"""Build the hand-written Hopper kernels in `csrc/` at first use and load
them with ctypes.

All `csrc/*.cu` files compile into one shared library with a plain C
interface (nvcc for sm_90a; seconds, where a build that includes PyTorch's
headers takes minutes). The library lands in `infinitevl_tpu_torch/_build/`
under a name carrying a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached file.

Every C entry point returns a cudaError_t code; `check` raises on a
non-zero one, which is how a refused launch surfaces."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_F32 = 0
DTYPE_BF16 = 1


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of infinitevl_tpu_torch are built from source at first use"
    )


def library_path() -> Path:
    """Path of the library built from the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libivl_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the cached library unless it already exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ivl_swa_prefill.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P]
    lib.ivl_swa_prefill.restype = I
    lib.ivl_swa_decode.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, P]
    lib.ivl_swa_decode.restype = I
    lib.ivl_delta_step.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.ivl_delta_step.restype = I
    lib.ivl_error_string.argtypes = [I]
    lib.ivl_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = load_library().ivl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
