"""Build the hand-written Hopper kernels in `csrc/` at first use and load
them with ctypes.

All `csrc/*.cu` files compile into one shared library with a plain C
interface (nvcc for sm_90a; seconds, where a build that includes PyTorch's
headers takes minutes): one nvcc per source, all started together, then
one link. The library lands in `infinitevl_tpu_torch/_build/` under a name
carrying a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the cached file.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _nvcc_failed(cmd, returncode: int, output: str) -> RuntimeError:
    return RuntimeError(
        f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n{output}"
    )


def build() -> Path:
    """Compile csrc/*.cu into the cached library unless it already exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    try:
        failure = None
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate()  # every compiler is waited for
            if proc.returncode != 0 and failure is None:
                failure = _nvcc_failed(cmd, proc.returncode, out + err)
        if failure is not None:
            raise failure
        tmp = BUILD_DIR / f"{tag}.tmp"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise _nvcc_failed(link, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(str(build()))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ivl_swa_prefill.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P]
    lib.ivl_swa_prefill.restype = I
    lib.ivl_swa_decode.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, P]
    lib.ivl_swa_decode.restype = I
    lib.ivl_delta_step.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.ivl_delta_step.restype = I
    lib.ivl_delta_chunk.argtypes = [I, P, P, P, P, P, P, P, P, P, L, I, I, I, I, I, F, P]
    lib.ivl_delta_chunk.restype = I
    lib.ivl_vit_flash.argtypes = [I, P, P, P, P, P, I, I, I, L, L, L, F, P]
    lib.ivl_vit_flash.restype = I
    lib.ivl_error_string.argtypes = [I]
    lib.ivl_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = load_library().ivl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
