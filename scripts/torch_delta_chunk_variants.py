#!/usr/bin/env python3
"""Variants of kernel C's bf16 passes (csrc/delta_chunk.cu) and of kernel B
(csrc/delta_step.cu), built side by side from edited copies of
infinitevl_tpu_torch/csrc/ and timed in one process on one card: where
each pass spends its time.

    python3 scripts/torch_delta_chunk_variants.py                    # every variant
    python3 scripts/torch_delta_chunk_variants.py base,clock,scan_no_o  # a subset

Each variant is the checkout's source with a few text edits (VARIANTS);
`base` is the source as it is and runs first and last (the spread). A
scratch tool for trying a design before changing csrc/: an edit that no
longer matches the source raises by name. Variants marked "exact" compute
kernel C's function and are held against the twin of its passes; a
"partial" one skips work and computes nothing meaningful; `clock` prints
clock64() stamps of block 0 at pass 1's phase boundaries and the scan's
first barriers. Per variant: registers and spills of the bf16 kernels
(ptxas), and at B 1, H 16, K 128, V 256 with a state, T 257 and 2,048, the
device time of each pass from the profiler and of one call in a CUDA graph
(chip_smoke.time_graph_ms); then kernel B's device time with the state
L2-cold at B 1 and 4 (chip_smoke._b_timings). Needs one CUDA card and
nvcc; nothing of the JAX package is imported."""

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
from infinitevl_tpu_torch.ops import delta_kernels as dk  # noqa: E402

SRC = "delta_chunk.cu"
STEP = "delta_step.cu"
# clock64() stamps of block (0, 0), thread 0, kept in registers and printed
# at the kernel's end: pass 1's phase boundaries, and the scan's barriers in
# its first three chunks
CLOCK = [
    (SRC, "namespace {\n\nusing ivl::ldsm_x2_trans;",
     "#include <cstdio>\n#define CLK(i) clk_[i] = clock64();\n"
     "namespace {\n\nusing ivl::ldsm_x2_trans;"),
    (SRC, "  // the chunk's q and k rows into Qs and Kn, asynchronously",
     "  long long clk_[8];\n  CLK(0)\n  // the chunk's q and k rows into Qs and Kn, asynchronously"),
    (SRC, "  // l2norm of the q and k rows in fp32, in place",
     "  CLK(1)\n  // l2norm of the q and k rows in fp32, in place"),
    (SRC, "  // k e^gcs beta (0 outside the first segment), rounded: the right-hand",
     "  CLK(2)\n  // k e^gcs beta (0 outside the first segment), rounded: the right-hand"),
    (SRC, "  // k k^T and q k^T on the tensor cores: warp (mt, nh) owns rows",
     "  CLK(3)\n  // k k^T and q k^T on the tensor cores: warp (mt, nh) owns rows"),
    (SRC, "  if (tid < CC) {\n    // (I + A)^-1 by forward substitution",
     "  CLK(4)\n  if (tid < CC) {\n    // (I + A)^-1 by forward substitution"),
    (SRC, "  // v beta, rounded, in place: the right-hand side of u",
     "  CLK(5)\n  // v beta, rounded, in place: the right-hand side of u"),
    (SRC, "  // [w | u] = X [k e^gcs beta | v beta]", "  CLK(6)\n  // [w | u] = X [k e^gcs beta | v beta]"),
    (SRC, "  }\n}\n\n// ------------------------------------------------------------ bf16 pass 2",
     "  }\n  CLK(7)\n  if (blockIdx.x == 0 && tid == 0) printf(\"prep clk %lld %lld %lld %lld %lld %lld "
     "%lld\\n\", clk_[1] - clk_[0], clk_[2] - clk_[1], clk_[3] - clk_[2], clk_[4] - clk_[3], "
     "clk_[5] - clk_[4], clk_[6] - clk_[5], clk_[7] - clk_[6]);\n}\n\n"
     "// ------------------------------------------------------------ bf16 pass 2"),
    (SRC, "  float keep_n = sc.keep[(long long)bh * N]",
     "  long long clk_[10];\n  CLK(0)\n  float keep_n = sc.keep[(long long)bh * N]"),
    (SRC, "    ivl::named_sync(1, P::CONSUMERS);  // Sb is whole; chunk n-1 is done with Y\n",
     "    ivl::named_sync(1, P::CONSUMERS);  // Sb is whole; chunk n-1 is done with Y\n"
     "    if (n < 3) CLK(1 + 3 * n)\n"),
    (SRC, "    ivl::named_sync(1, P::CONSUMERS);  // Y is whole; Sb is no longer read\n",
     "    ivl::named_sync(1, P::CONSUMERS);  // Y is whole; Sb is no longer read\n"
     "    if (n < 3) CLK(2 + 3 * n)\n"),
    (SRC, "    keep_n = keep_next;\n    bend_n = bend_next;\n",
     "    if (n < 3) CLK(3 + 3 * n)\n    keep_n = keep_next;\n    bend_n = bend_next;\n"),
    (SRC, "    *reinterpret_cast<float2*>(hT + off + 8 * (size_t)V) = make_float2(s[nt][2], s[nt][3]);"
          "\n  }\n}",
     "    *reinterpret_cast<float2*>(hT + off + 8 * (size_t)V) = make_float2(s[nt][2], s[nt][3]);"
     "\n  }\n  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0 && N >= 3) printf(\"scan clk "
     "%lld %lld %lld %lld %lld %lld %lld %lld %lld\\n\", clk_[1] - clk_[0], clk_[2] - clk_[1], "
     "clk_[3] - clk_[2], clk_[4] - clk_[3], clk_[5] - clk_[4], clk_[6] - clk_[5], "
     "clk_[7] - clk_[6], clk_[8] - clk_[7], clk_[9] - clk_[8]);\n}"),
]
# the inverse by blocks (the `blocked_inverse` variant's code)
BLOCKED = r"""  // the chunk's v rows over Kn and Qs, under the inverse
  rows_async(Rv, V + 8, v + row0 * V, (size_t)H * V, V, valid, tid, 0, B_THREADS);
  cp_async_commit();
  float* Tm = reinterpret_cast<float*>(sid + CC);
  if (tid < CC) {
    const int r0 = tid & ~(SB - 1), c = tid & (SB - 1);
    float acc[SB];
#pragma unroll
    for (int r = 0; r < SB; ++r) acc[r] = r == c ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < SB - 1; ++j)
#pragma unroll
      for (int r = j + 1; r < SB; ++r) acc[r] -= AsT[(r0 + j) * AST + r0 + r] * acc[j];
#pragma unroll
    for (int r = 0; r < SB; ++r) Xs[(r0 + r) * CC + r0 + c] = acc[r];
  } else {
    for (int e = tid - CC; e < CC * CC; e += B_THREADS - CC) {
      const int r = e / CC, c = e % CC;
      if (c / SB > r / SB) Xs[e] = 0.f;
    }
  }
  __syncthreads();
  for (int i = 1; i < CC / SB; ++i) {
    for (int e = tid; e < i * SB * SB; e += B_THREADS) {
      const int j = e / (SB * SB), r = (e / SB) % SB, c = e % SB;
      float t = 0.f;
      for (int k = SB * j; k < SB * i; ++k)
        t += AsT[k * AST + SB * i + r] * Xs[k * CC + SB * j + c];
      Tm[e] = t;
    }
    __syncthreads();
    for (int e = tid; e < i * SB * SB; e += B_THREADS) {
      const int j = e / (SB * SB), r = (e / SB) % SB, c = e % SB;
      float x = 0.f;
      for (int k = 0; k <= r; ++k)
        x -= Xs[(SB * i + r) * CC + SB * i + k] * Tm[j * SB * SB + k * SB + c];
      Xs[(SB * i + r) * CC + SB * j + c] = x;
    }
    __syncthreads();
  }
  for (int e = tid; e < CC * CC; e += B_THREADS)
    Xb[(e / CC) * XS + e % CC] = __float2bfloat16(Xs[e]);
  cp_async_wait<0>();
  __syncthreads();

"""
# variant: (text edits, kind): "exact" variants compute kernel C's function
# and are checked, "partial" ones skip work, "clock" prints its stamps
VARIANTS = {
    "base": ([], "exact"),
    "clock": (CLOCK, "clock"),
    # the scan without the output (option (a)'s scan, but for its writes of
    # the per-chunk states and y): no q e^gcs or masked q k^T loaded, no
    # (q e^gcs) S, tril(q k^T) y or o
    "scan_no_o": ([
        (SRC, "        for (int m = 0; m < 3; ++m)  // w, qb, kout: two boxes each",
         "        for (int m = 0; m < 3; m += 2)  // w, qb, kout: two boxes each"),
        (SRC, "        ivl::tma_load_2d(st + 3 * KC, &amap, &full[s], 0, row);\n", ""),
        (SRC, "        ivl::mbar_arrive_tx(&full[s], 2 * STAGE);",
         "        ivl::mbar_arrive_tx(&full[s], 2 * (STAGE - KC - CC * CC));"),
        (SRC, "      ldsm_x4(fq, smem_u32(QB + swz(arow, 16 * ks + acol)));\n", ""),
        (SRC, "          mma_bf16(ao[2 * p], fq, fb[0], fb[1]);\n"
              "          mma_bf16(ao[2 * p + 1], fq, fb[2], fb[3]);\n", ""),
        (SRC, "        mma_bf16(ao[0], fq, fb[0], fb[1]);\n", ""),
        (SRC, "    for (int ks = 0; ks <= mt; ++ks) {\n      uint32_t fa[4];",
         "    for (int ks = 0; ks < 0; ++ks) {\n      uint32_t fa[4];"),
        (SRC, "      if (t < Tn)\n        *reinterpret_cast<uint32_t*>(o +",
         "      if (t < 0)\n        *reinterpret_cast<uint32_t*>(o +"),
        (SRC, "      if (t + 8 < Tn)\n", "      if (t + 8 < 0)\n"),
        (SRC, "      uint32_t fw[4], fq[4];", "      uint32_t fw[4];"),
    ], "partial"),
    # pass 1 forming the inverse by 16-row blocks with all eight warps (FLA's
    # solve_tril: X_ii by substitution, then X_ij = -X_ii sum_k A_ik X_kj),
    # v loaded before it (3 KB more shared memory, for the partial sums)
    "blocked_inverse": ([
        (SRC, "  if (tid < CC) {\n    // (I + A)^-1 by forward substitution",
         "  if (false) {\n    // (I + A)^-1 by forward substitution"),
        (SRC, "  } else {\n    // meanwhile the other six warps",
         "  } else if (false) {\n    // meanwhile the other six warps"),
        (SRC, "    cp_async_wait<0>();\n  }\n  __syncthreads();\n\n  // v beta, rounded, in place",
         "    cp_async_wait<0>();\n  }\n" + BLOCKED + "  // v beta, rounded, in place"),
        (SRC, "  return 2 * (3 * CC * KS + CC * XS) + 4 * (CC * AST + CC * CC + 5 * CC) + 4 * CC;",
         "  return 2 * (3 * CC * KS + CC * XS) + 4 * (CC * AST + CC * CC + 5 * CC) + 4 * CC + "
         "4 * 3 * SB * SB;"),
    ], "exact"),
    # kernel B with 256 or 64 threads a block
    "b_t256": ([(STEP, "constexpr int B_THREADS = 128;", "constexpr int B_THREADS = 256;")],
               "exact"),
    "b_t64": ([(STEP, "constexpr int B_THREADS = 128;", "constexpr int B_THREADS = 64;")],
              "exact"),
}


def build(name: str, work: Path) -> ctypes.CDLL:
    """The variant's library (delta_chunk.cu; swa_ring_flash.cu for the
    error strings), with ptxas's registers and spills of the bf16 kernels."""
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
           str(lib_path), str(src / SRC), str(src / STEP), str(src / "swa_ring_flash.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr[-3000:]}")
    regs = re.findall(r"Function properties for \S*(delta_chunk_\w*bf16_kernel\w*)\n\s*\d+ "
                      r"bytes stack frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
                      proc.stdout + proc.stderr)
    print(f"[{name}] built: " + ", ".join(f"{k[:40]}: {r} registers, {sp} bytes spilled"
                                          for k, sp, r in regs), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ivl_delta_chunk.argtypes = [I, P, P, P, P, P, P, P, P, P, P, L, I, I, I, I, I, F, I, P]
    lib.ivl_delta_chunk.restype = I
    lib.ivl_delta_step.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, F, P]
    lib.ivl_delta_step.restype = I
    lib.ivl_error_string.argtypes = [I]
    lib.ivl_error_string.restype = ctypes.c_char_p
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_delta_chunk_variants: no CUDA card", file=sys.stderr)
        return 2
    names = argv[0].split(",") if argv else list(VARIANTS)
    if names[0] != "base":
        names.insert(0, "base")
    work = Path(tempfile.mkdtemp(prefix="delta_variants_"))
    try:
        libs = {name: build(name, work) for name in names}
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = {T: cs._c_inputs(dev, gen, 1, T, torch.bfloat16) for T in (257, 2048)}
        load_library = _build.load_library
        try:
            for name in names + ["base"]:
                _build.load_library = lambda lib=libs[name]: lib
                parts = []
                kind = VARIANTS[name][1]
                if kind == "clock":  # one call a shape; the device prints its stamps
                    for T, (q, k, v, g, beta, h0, _) in cases.items():
                        print(f"[{name}] T {T}:", flush=True)
                        dk.delta_rule_chunk_fused(q, k, v, g, beta, h0)
                        torch.cuda.synchronize()
                    continue
                for T, (q, k, v, g, beta, h0, _) in cases.items():
                    call = lambda: dk.delta_rule_chunk_fused(q, k, v, g, beta, h0)
                    if kind == "exact":
                        o, hT = call()
                        ro, rh = dk.delta_chunk_passes(q, k, v, g, beta, h0)
                        e = max(cs.err_ratio(o, ro), cs.err_ratio(hT, rh))
                        cs.require(e <= cs.BF16_TOL, f"variant {name} T {T}: err_ratio {e:.3g}")
                        parts.append(f"T {T} err_ratio {e:.2e}")
                    _, _, _, rows = cs._device_profile(call)
                    passes = ", ".join(f"{'prep' if 'prep' in nm else 'scan'} {t:.4f}"
                                       for t, _, nm in rows if "delta_chunk" in nm)
                    parts.append(f"T {T}: {passes}, graph {cs.time_graph_ms(call):.4f}")
                b = cs._b_timings(dev, gen)
                parts.append("B L2-cold " + ", ".join(
                    f"B {B_} {r['device_ms']:.4f} (kernel {r['rows'][0][0] * 1e3:.2f} us)"
                    for B_, r in b.items()))
                print(f"[{name}] device ms: " + "; ".join(parts), flush=True)
        finally:
            _build.load_library = load_library
        print(f"card '{cs.card_line()}'", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
