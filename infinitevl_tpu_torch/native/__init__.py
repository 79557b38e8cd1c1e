"""ctypes bindings for the native host preprocessing library (torch port
of infinitevl_tpu/native/: the same C++ source, `preprocess.cpp`).

`preprocess_frame` runs resize -> CLIP-normalize -> merger-aware patchify
in one C++ pass; `FramePipeline` runs it on pthread workers, so frames are
prepared while the card computes (submit, then collect by ticket). The
library is built with g++ at first use into `infinitevl_tpu_torch/_build/`
under a name carrying a hash of the source, the flags and the host's CPU
(`-march=native`), never beside the source. `available()` says whether it built; the calls raise where it did
not: nothing switches to the numpy pipeline of data/processing.py behind
the caller's back. No path of the package calls it (as in the JAX package);
it is a library function for hosts that feed frames."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

OPENAI_CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def _cpu() -> bytes:
    """The host CPU's identity (`-march=native` builds for it): its model
    and flags lines, or the machine's name where /proc/cpuinfo is absent."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


def library_path() -> Path:
    """Path of the library built from the current source and flags for this
    host's CPU."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_cpu())
    return BUILD_DIR / f"libivl_preprocess_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile preprocess.cpp (g++) unless the library for this source
    exists; raises where the compiler fails or is missing."""
    lib = library_path()
    with _lock:
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so")
            subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                           capture_output=True)
            os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ivl_preprocess_frame.restype = ctypes.c_int
        lib.ivl_preprocess_frame.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, ctypes.c_int,
        ]
        lib.ivl_pipeline_create.restype = ctypes.c_void_p
        lib.ivl_pipeline_create.argtypes = [ctypes.c_int]
        lib.ivl_pipeline_destroy.argtypes = [ctypes.c_void_p]
        lib.ivl_pipeline_submit.restype = ctypes.c_int
        lib.ivl_pipeline_submit.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, ctypes.c_int,
        ]
        lib.ivl_pipeline_collect.restype = ctypes.c_int
        lib.ivl_pipeline_collect.argtypes = [
            ctypes.c_void_p, ctypes.c_int, f32p, ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        get_lib()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def preprocess_frame(
    img: np.ndarray,  # [H, W, C] uint8
    out_hw: Tuple[int, int],
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    bicubic: bool = True,
) -> np.ndarray:
    """Fused native resize + normalize + patchify of one frame (repeated
    over the temporal patch). Returns [grid_h * grid_w, C * tps * ps * ps]
    float32 in the merger-aware order of data/processing.patchify."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W, C = img.shape
    oh, ow = out_hw
    gh, gw = oh // patch_size, ow // patch_size
    out = np.empty((gh * gw, C * temporal_patch_size * patch_size * patch_size), np.float32)
    rc = lib.ivl_preprocess_frame(
        _u8ptr(img), H, W, C, oh, ow, patch_size, temporal_patch_size,
        merge_size, _fptr(OPENAI_CLIP_MEAN), _fptr(OPENAI_CLIP_STD),
        _fptr(out), int(bicubic),
    )
    if rc < 0:
        raise ValueError(f"native preprocess failed: rc={rc}")
    return out


class FramePipeline:
    """Threaded prefetcher: submit raw frames while the card computes, then
    collect each result by its ticket."""

    def __init__(self, workers: int = 2, **kwargs):
        self.lib = get_lib()
        self.handle = self.lib.ivl_pipeline_create(workers)
        self.kwargs = kwargs

    def submit(self, img: np.ndarray, out_hw: Tuple[int, int]) -> int:
        img = np.ascontiguousarray(img, dtype=np.uint8)
        H, W, C = img.shape
        k = self.kwargs
        return self.lib.ivl_pipeline_submit(
            self.handle, _u8ptr(img), H, W, C, out_hw[0], out_hw[1],
            k.get("patch_size", 14), k.get("temporal_patch_size", 2),
            k.get("merge_size", 2), _fptr(OPENAI_CLIP_MEAN),
            _fptr(OPENAI_CLIP_STD), int(k.get("bicubic", True)),
        )

    def collect(self, ticket: int, out_hw: Tuple[int, int]) -> np.ndarray:
        k = self.kwargs
        ps = k.get("patch_size", 14)
        tps = k.get("temporal_patch_size", 2)
        gh, gw = out_hw[0] // ps, out_hw[1] // ps
        out = np.empty((gh * gw, 3 * tps * ps * ps), np.float32)
        rc = self.lib.ivl_pipeline_collect(self.handle, ticket, _fptr(out), out.size)
        if rc < 0:
            raise ValueError(f"collect failed rc={rc}")
        return out

    def close(self):
        if self.handle:
            self.lib.ivl_pipeline_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
