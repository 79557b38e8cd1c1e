#!/usr/bin/env python3
"""Variants of the bf16 body of kernels E and F (csrc/vit_flash.cu on the
shared mainloop csrc/swa_fwd_wgmma.cuh), built side by side from edited
copies of infinitevl_tpu_torch/csrc/ and timed in one process on one card:
what bounds the kernel and what each design choice buys.

    python3 scripts/torch_vit_flash_variants.py                  # every variant
    python3 scripts/torch_vit_flash_variants.py base,cwg1,nofast # a subset

Each variant is the checkout's source with a few text edits and, where
it says so, a fixed count of consumer warpgroups a block in place of the
wrapper's choice (VARIANTS); `base` is the source as it is and runs first
and last (the spread). A scratch tool for trying a design before changing
csrc/: an edit that no longer matches the source raises by name. Per
variant: registers and spills of the kernel's instances (ptxas), E (three
segments with pads, S 4,100) and F (L 40 with pads, S 1,000) against their
plain versions (err_ratio; not for the load-only variants, whose outputs
are not attention), and the device time of one call in a CUDA graph
(chip_smoke.time_graph_ms) of E at S 9,216 and 1,024 and F at S 9,216 with
L 1,024 / 256 / 64 and at S 1,024 with L 64. Needs one CUDA card and nvcc;
nothing of the JAX package is imported."""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from infinitevl_tpu_torch.ops import _build  # noqa: E402
from infinitevl_tpu_torch.ops import vit_kernels as vk  # noqa: E402
from infinitevl_tpu_torch.ops.vit_flash import (  # noqa: E402
    attention_segment_chunked,
    window_attention_reference,
)

MAINLOOP = "swa_fwd_wgmma.cuh"
VIT = "vit_flash.cu"
# the consumers release every stage unread: the K/V stream alone
LOAD_ONLY = (MAINLOOP, "    mbar_wait(&full[s], (it / FW_STAGES) & 1);\n    ++it;\n",
             "    mbar_wait(&full[s], (it / FW_STAGES) & 1);\n    ++it;\n"
             "    if (true) {\n      mbar_arrive(&empty[s]);\n      continue;\n    }\n")
# variant: (text edits, consumer warpgroups a block whatever the shape or
# None for the wrapper's choice)
VARIANTS = {
    "base": ([], None),
    "cwg1": ([], 1),
    "cwg2": ([], 2),
    "cwg3": ([], 3),
    # the softmax as A1 and H run it (exp2f, the scale a separate multiply)
    "nofast": ([(VIT, "static constexpr bool VOTE = true, FAST = true;",
                 "static constexpr bool VOTE = true, FAST = false;")], None),
    "stages3": ([(MAINLOOP, "constexpr int FW_STAGES = 2;", "constexpr int FW_STAGES = 3;")],
                None),
    "loadonly_cwg1": ([LOAD_ONLY], 1),
    # the same stream as 64-column boxes in the 128-byte swizzle (16 KB a
    # tile, columns 80-127 zero-filled), the layout of route (b)
    "load128_cwg1": ([
        LOAD_ONLY,
        (MAINLOOP, "SLAB = FW_T * 32, BYTES = 5 * SLAB,", "SLAB = FW_T * 32, BYTES = 2 * FW_HALF,"),
        (VIT, "  for (int g = 0; g < VD / 16; ++g)\n"
              "    ivl::tma_load_3d(dst + g * VTile::SLAB, map, bar, 16 * g, h, t0);",
         "  for (int g = 0; g < 2; ++g)\n"
         "    ivl::tma_load_3d(dst + g * ivl::FW_HALF, map, bar, 64 * g, h, t0);"),
        (VIT, "const cuuint32_t box[3] = {16, 1, ivl::FW_T};",
         "const cuuint32_t box[3] = {64, 1, ivl::FW_T};"),
        (VIT, "CU_TENSOR_MAP_SWIZZLE_32B);", "CU_TENSOR_MAP_SWIZZLE_128B);"),
    ], 1),
}


def build(name: str, work: Path) -> ctypes.CDLL:
    """The variant's library (vit_flash.cu; swa_ring_flash.cu for the error
    strings), with ptxas's registers and spills of the wgmma instances."""
    src = work / name
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in VARIANTS[name][0]:
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {fname} has no {old!r}")
        path.write_text(text.replace(old, new))
    lib_path = src / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
           str(lib_path), str(src / VIT), str(src / "swa_ring_flash.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr[-3000:]}")
    regs = re.findall(r"Function properties for \S*vit_flash_wgmma_kernelILi(\d)\S*\n\s*\d+ "
                      r"bytes stack frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
                      proc.stdout + proc.stderr)
    print(f"[{name}] built: " + ", ".join(f"CWG {c}: {r} registers, {sp} bytes spilled"
                                          for c, sp, r in sorted(regs)), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ivl_vit_flash.argtypes = [I, P, P, P, P, P, I, I, I, L, L, L, F, I, I, P]
    lib.ivl_vit_flash.restype = I
    lib.ivl_error_string.argtypes = [I]
    lib.ivl_error_string.restype = ctypes.c_char_p
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_vit_flash_variants: no CUDA card", file=sys.stderr)
        return 2
    names = argv[0].split(",") if argv else list(VARIANTS)
    if names[0] != "base":
        names.insert(0, "base")
    work = Path(tempfile.mkdtemp(prefix="vit_variants_"))
    try:
        libs = {name: build(name, work) for name in names}
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        H, D, bf = 16, 80, torch.bfloat16
        cases = []
        for S, L in ((9216, 0), (1024, 0), (9216, 1024), (9216, 256), (9216, 64), (1024, 64)):
            q, k = (torch.randn((S, H, D), generator=gen, device=dev).to(bf) for _ in range(2))
            v = torch.randn((S, 3, H, D), generator=gen, device=dev).to(bf)[:, 2]
            seg = (torch.arange(S, device=dev, dtype=torch.int32) // L if L
                   else torch.zeros(S, dtype=torch.int32, device=dev))
            cases.append((f"E S{S}" if L == 0 else f"F S{S} L{L}", q, k, v, seg, L))
        S = 4100
        qe, ke, ve = torch.randn((S, 3, H, D), generator=gen, device=dev).to(bf).unbind(1)
        sege = torch.zeros(S, dtype=torch.int32, device=dev)
        sege[S * 2 // 5: S * 3 // 4] = 1
        sege[S * 3 // 4:] = 2
        sege[torch.randperm(S, generator=gen, device=dev)[: S // 50]] = -1
        ref_e = attention_segment_chunked(qe, ke, ve, sege)
        segf = cs._window_segments(1000, 40, dev, gen)
        qf, kf, vf = torch.randn((1000, 3, H, D), generator=gen, device=dev).to(bf).unbind(1)
        ref_f = window_attention_reference(qf, kf, vf, segf, 40)
        load_library, warpgroups = _build.load_library, vk.vit_warpgroups
        try:
            for name in names + ["base"]:
                _build.load_library = lambda lib=libs[name]: lib
                cwg = VARIANTS[name][1]
                vk.vit_warpgroups = warpgroups if cwg is None else lambda *a, cwg=cwg: cwg
                parts = []
                if not name.startswith("load"):
                    e = cs.err_ratio(vk.segment_flash_attention(qe, ke, ve, sege), ref_e)
                    f = cs.err_ratio(vk.window_flash_attention(qf, kf, vf, segf, 40), ref_f)
                    cs.require(e <= cs.BF16_TOL and f <= cs.BF16_TOL,
                               f"variant {name}: err_ratio E {e:.3g}, F {f:.3g}")
                    parts.append(f"err_ratio E {e:.2e}, F L40 {f:.2e}")
                for label, q, k, v, seg, L in cases:
                    if L:
                        fn = lambda q=q, k=k, v=v, seg=seg, L=L: vk.window_flash_attention(
                            q, k, v, seg, L)
                    else:
                        fn = lambda q=q, k=k, v=v, seg=seg: vk.segment_flash_attention(q, k, v, seg)
                    parts.append(f"{label} {cs.time_graph_ms(fn):.4f}")
                print(f"[{name}] device ms: " + "; ".join(parts), flush=True)
        finally:
            _build.load_library, vk.vit_warpgroups = load_library, warpgroups
        print(f"card '{cs.card_line()}'", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
