#!/usr/bin/env python3
"""The card's mma.sync TF32 rate, the ceiling of the fused kernels'
float32 GEMM arm (csrc/fcs_gemm.cuh), and that arm's folded and direct
forms.

    python3 tools/mma_tf32_bench.py [--iters 4096] [--waves 4]

Builds a small CUDA source with nvcc (sm_90a, plain C interface, into
build/mma_tf32_bench/) and times, with CUDA events, blocks of 512 threads
(16 warps, one block per SM, waves x 132 blocks) that each issue iters
steps of NTILE independent chains of the GEMM arm's three TF32 products
(lo hi, hi lo, hi hi, m16n8k8) on register operands: 'raw' accumulates
the chain in the MMAs' own accumulator, 'promoted' (the GEMM arm's form)
sums each step's chain from zero and adds it to an FP32 accumulator.
The operands change every step and differ by tile, so nothing is
hoisted or shared; a rate above the card's dense TF32 peak (495 TFLOP/s)
means the compiler removed work, and fails the run.  Then it builds the
package's kernels and times the GEMM arm's spectrum launch
(ppt_fcs_spectrum_f32, chip_smoke.gemm_spectrum_f32) over the rows of
B1's 64 x 512 x 1022 call (and its template's 512), K = 384, in the
folded form the wrapper takes at even nbin and in the direct form an odd
nbin takes (median of 20 x 5 calls, CUDA events), each beside its
three-product TF32 bound.  Prints one line per form and tile count, one
per GEMM form, and the card's name and power limit.  Needs one CUDA card
and nvcc.
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_TF32_FLOPS = 495e12
# the GEMM forms' rows (64 x 512 data rows and 512 template rows), bins, K
FORM_ROWS, FORM_NBIN, FORM_K = 64 * 512 + 512, 1022, 384
SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool PROMOTED, int NTILE>
__global__ void __launch_bounds__(512, 1) bench(float* out, int iters) {
  uint32_t a[4], al[4], b[2], bl[2];
  for (int i = 0; i < 4; ++i) {
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
    al[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  }
  b[0] = __float_as_uint(0.5f); b[1] = __float_as_uint(0.25f);
  bl[0] = __float_as_uint(1e-4f); bl[1] = __float_as_uint(2e-4f);
  float acc[NTILE][4] = {};
  for (int it = 0; it < iters; ++it) {
    al[0] ^= (uint32_t)it << 13;  // a new operand every step
#pragma unroll
    for (int t = 0; t < NTILE; ++t) {
      const uint32_t bt[2] = {b[0] + (uint32_t)t, b[1]};  // one per tile
      if (PROMOTED) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        mma(s, al, bt); mma(s, a, bl); mma(s, a, bt);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] += s[e];
      } else {
        mma(acc[t], al, bt); mma(acc[t], a, bl); mma(acc[t], a, bt);
      }
    }
  }
  float s = 0.f;
  for (int t = 0; t < NTILE; ++t)
    for (int e = 0; e < 4; ++e) s += acc[t][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool P, int N>
static float run_one(float* out, int iters, int blocks) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  bench<P, N><<<blocks, 512>>>(out, iters);
  cudaEventRecord(e0);
  bench<P, N><<<blocks, 512>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}

extern "C" int run(int promoted, int ntile, int iters, int blocks,
                   float* ms) {
  float* out;
  if (cudaMalloc(&out, sizeof(float) * 512 * blocks)) return 1;
  *ms = -1.f;
  if (!promoted && ntile == 8) *ms = run_one<false, 8>(out, iters, blocks);
  if (!promoted && ntile == 16) *ms = run_one<false, 16>(out, iters, blocks);
  if (promoted && ntile == 8) *ms = run_one<true, 8>(out, iters, blocks);
  if (promoted && ntile == 16) *ms = run_one<true, 16>(out, iters, blocks);
  cudaFree(out);
  return (int)cudaGetLastError();
}
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--waves", type=int, default=4)
    a = ap.parse_args()
    out = os.path.join(HERE, "build", "mma_tf32_bench")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, "bench.cu"), os.path.join(out, "bench.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-O3", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                   check=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_float)]
    blocks = 132 * a.waves
    for promoted in (0, 1):
        for ntile in (8, 16):
            ms = ctypes.c_float()
            rc = lib.run(promoted, ntile, a.iters, blocks, ctypes.byref(ms))
            if rc != 0 or ms.value <= 0:
                print(f"mma_tf32_bench: cudaError {rc}", file=sys.stderr)
                return 1
            flop = 2048.0 * 3 * ntile * a.iters * 16 * blocks
            rate = flop / ms.value * 1e3
            print(f"{'promoted' if promoted else 'raw'} chains, {ntile} "
                  f"tiles a warp: {ms.value:.3f} ms, "
                  f"{rate / 1e12:.1f} TFLOP/s of TF32 MMA "
                  f"({rate / 3e12:.1f} FP32-accurate)", flush=True)
            if rate > PEAK_TF32_FLOPS:
                print(f"mma_tf32_bench: {rate / 1e12:.1f} TFLOP/s is above "
                      f"the card's {PEAK_TF32_FLOPS / 1e12:.0f}: the "
                      "compiler removed work", file=sys.stderr)
                return 1
    gemm_forms()
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    print(r.stdout.strip().splitlines()[0] if r.stdout else "nvidia-smi: -")
    return 0


def gemm_forms():
    """The GEMM arm's spectrum launch at FORM_ROWS x FORM_NBIN, K = FORM_K,
    folded and direct, each beside its three-product TF32 bound."""
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as C
    from pulseportraiture_tpu_torch.ops import fused as F

    F.build_kernels()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((FORM_ROWS, FORM_NBIN), generator=g, device="cuda")
    for fold in (True, False):
        L = FORM_NBIN // 2 - 1 if fold else FORM_NBIN
        bound = 12.0 * FORM_ROWS * L * FORM_K / PEAK_TF32_FLOPS * 1e3
        ms = C.median_ms(lambda: C.gemm_spectrum_f32(x, FORM_K, fold))
        print(f"GEMM arm spectrum launch {FORM_ROWS} x {FORM_NBIN} K={FORM_K}"
              f" {'folded' if fold else 'direct'}: {ms:.4f} ms (three-product"
              f" TF32 bound {bound:.4f} ms, {100.0 * bound / ms:.1f} %)",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
