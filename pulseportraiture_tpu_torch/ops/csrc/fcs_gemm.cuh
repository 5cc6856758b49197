// The windowed-DFT -> cross-spectrum GEMM shared by the two fused
// kernels (fused_cross_spectrum.cu, fused_decode_cross_spectrum.cu): the
// GEMM arm of the ports of the TPU Pallas kernels
// fused_cross_spectrum_pallas and fused_decode_cross_spectrum_pallas
// (pulseportraiture_tpu/ops/fused.py), which carry the DFT on the MXU as
// a matrix product.
//
// Shape rule between the arms (ops/fused.py fft_arm): this arm takes
// every shape the FFT arm (fft_smem.cuh) does not, i.e. an nbin with a
// prime factor above 5 (1022 = 2 7 73, 1032 = 2^3 3 43), above 8192 or
// below 16, or K > nbin/2 + 1.
//
// For every data row r (one channel of one subint) and harmonic k < K:
//
//   dr = sum_j x[r, j] Wc[j, k],  di = sum_j x[r, j] Ws[j, k]
//   Xr = (dr mr + di mi) w,  Xi = (di mr - dr mi) w
//   S0[r] = sum_k (mr^2 + mi^2) w        (or the full M2w row)
//
// with (mr, mi) the same DFT of the row's model (a shared template row
// r % nchan, or a per-element model row r).  Fold mode contracts the
// half-length symmetric/antisymmetric sums against (n/2-1, K) twiddles
// and adds x[0] + x[n/2] (-1)^k to dr.
//
// The data operand x is read through a Loader: ld(row, j) returns the
// row's j-th sample in T.  The dense loader reads a float portrait; the
// packed loader decodes sub-byte samples as it stages them (B2's exact
// decode), so the decoded portrait never reaches device memory.
//
// float32: three-product TF32 on the tensor cores (fcs_tc_kernel).
//   Bound on this card: tensor-core throughput.  The GEMM does 4 nbin K
//   FLOPs per row, ~K/2 FLOPs per byte read, far above the ridge; FP32
//   accuracy takes three TF32 products per FP32 product (x_hi w_hi +
//   x_hi w_lo + x_lo w_hi; only lo lo, ~2^-22 relative, is dropped), so
//   the ceiling is a third of the 495 TFLOP/s dense TF32 rate, 165
//   TFLOP/s, against 67 for FP32 FMAs.  The design:
//   - the twiddles' hi = rna_tf32(w) and lo = rna_tf32(w - hi) come from
//     the host (ops/fourier.py "tf32x3": built in float64, K-major, time
//     zero-padded to TC_BK, harmonics to TC_BH), by 16-byte cp.async into
//     a two-stage shared-memory ring; each data sample is split in
//     registers as it is staged (cvt.rna.tf32.f32 of x and of x - x_hi),
//     so the loaders' decode and fold sums are unchanged;
//   - mma.sync.m16n8k8 TF32 with A (data) and B (twiddles) fragments
//     read by ldmatrix from padded shared rows (stride TC_BK + 4: no
//     bank conflict).  wgmma would reach the full rate but takes B only
//     through shared-memory descriptors whose layouts cannot be checked
//     without the card's compiler; mma.sync keeps every fragment in a
//     layout the CPU tests mirror, at ~2/3 of the wgmma rate
//     (tools/mma_tf32_bench.py);
//   - accumulation with promotion: the tensor cores' internal sums may
//     truncate (measured on V100-A100), and a baselined row's DC harmonic
//     sums ~1000 values of one sign.  So each three-product chain covers
//     one k8 step (8 samples) in a zeroed fragment, which is then added
//     to the FP32 accumulator with a round-to-nearest add, in a fixed
//     order;
//   - a block owns 128 rows x 128 harmonics (cos and sin, 256 columns;
//     16 warps of 32 rows x 32 harmonics, 64 accumulators a thread, at
//     most 32 bytes of spill at 128 registers; 8 warps of 64 x 32 needed
//     255 and spilled 260-408), so a row is read ceil(K/128) times, by
//     blocks launched side by side (a 1-D grid whose fast index is the
//     harmonic tile, so the row count has no 65535-block cap) that find
//     it in L2, and a twiddle chunk serves 128 rows; the
//     template's spectrum launch takes 64-row blocks (few rows, more
//     blocks); a thread stages consecutive samples of one row, its
//     loader row (and B2's decode constants) read once;
//   - the wrapper (ops/fused.py _gemm_weights) hands this arm the folded
//     twiddles for every even nbin: the symmetric and antisymmetric sums
//     x[j] +- x[n - j] are formed as the samples are staged, and the cos
//     (sin) columns take the first (second) plane, which halves the
//     tensor-core products; an odd nbin takes the direct form;
//   - a spectrum launch lets the cross launch after it start early
//     (programmatic dependent launch); the cross launch waits for the
//     spectrum only before its epilogue;
//   - batch invariance (ROADMAP C8): a row's outputs depend on that row
//     alone: a fixed chunk order, no split of the time axis, no atomics,
//     rows past M zero-filled, and S0 summed by the harmonic-tile-0
//     block over all K in a fixed order (a warp per row, lanes strided
//     over k, then a fixed butterfly).
// float64: the register-tiled SIMT GEMM below (fcs_kernel), bound by
//   FP64 FMA throughput: a block owns a (16 TM)-row x 64-harmonic output
//   tile; each of its 256 threads accumulates a TM-row x 4-harmonic
//   sub-tile of BOTH the cos and the sin product in registers (TM = 4),
//   over 16-sample time chunks staged in shared memory, the next chunk
//   fetched into registers while the current one is multiplied; the
//   data chunk is stored transposed (padded against bank conflicts), the
//   fold sums formed while staging; S0 walks all harmonic tiles of its
//   rows in one block and reduces the per-thread partial sums in shared
//   memory in a fixed order, with no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fft_smem.cuh"  // allow_smem

// Internal linkage in every source that includes this header: each
// kernel library instantiates and registers its own copies.
namespace {

constexpr int BN = 64;   // harmonics per tile
constexpr int BK = 16;   // time samples per staged chunk
constexpr int TN = 4;    // harmonics per thread (contiguous)
constexpr int NT = 256;  // threads per block (16 x 16)

// rows per thread of the SIMT GEMM (float64's register budget)
template <typename T>
struct Tile {
  static constexpr int TM = 4;
  static constexpr int BM = 16 * TM;   // rows per block
  static constexpr int LDA = BM + 4;   // padded row stride of As
};

enum Mode { SPECTRUM = 0, CROSS = 1 };

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// four contiguous, 16-byte aligned shared-memory values
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// a dense (M, nbin) portrait
template <typename T>
struct DenseRows {
  const T* x;
  int nbin;
  __device__ __forceinline__ T operator()(int64_t row, int j) const {
    return x[row * nbin + j];
  }
  // one row's samples: at(row)(j) = (*this)(row, j)
  struct Row {
    const T* p;
    __device__ __forceinline__ T operator()(int j) const { return p[j]; }
  };
  __device__ __forceinline__ Row at(int64_t row) const {
    return {x + row * nbin};
  }
};

template <typename T, bool FOLD, int MODE, class Loader>
__global__ void __launch_bounds__(NT) fcs_kernel(
    Loader ld, int64_t M, int nbin,
    const T* __restrict__ Wc, const T* __restrict__ Ws,
    const T* __restrict__ sgn, int L, int K, int kt_per_block,
    const T* __restrict__ mr, const T* __restrict__ mi, int64_t m_mod,
    const T* __restrict__ w, int64_t w_mod,
    T* __restrict__ out_r, T* __restrict__ out_i, T* __restrict__ o2,
    int want_m2) {
  constexpr int TM = Tile<T>::TM;
  constexpr int BM = Tile<T>::BM;
  constexpr int LDA = Tile<T>::LDA;
  constexpr int NA = (BM * BK) / NT;  // data values staged per thread
  constexpr int NB = (BK * BN) / NT;  // twiddles staged per thread
  __shared__ __align__(16) T As[BK][LDA];
  __shared__ __align__(16) T Ao[FOLD ? BK : 1][LDA];
  __shared__ __align__(16) T Bc[BK][BN];
  __shared__ __align__(16) T Bs[BK][BN];
  __shared__ T red[BM][17];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // harmonics tx*4 .. tx*4+3 of the tile
  const int ty = tid >> 4;   // rows ty*TM .. ty*TM+TM-1 of the block
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int nkt = (K + BN - 1) / BN;
  const int kt0 = blockIdx.y * kt_per_block;
  const int kt1 = min(nkt, kt0 + kt_per_block);

  T s0[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) s0[i] = T(0);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BN;
    T accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        accr[i][j] = T(0);
        acci[i][j] = T(0);
      }

    // global -> register prefetch of the next chunk overlaps its load
    // latency with the FMAs on the chunk staged in shared memory
    T pa[NA], pb[FOLD ? NA : 1], pc[NB], ps[NB];
    auto fetch = [&](int j0) {
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const int e = tid + NT * q;
        const int64_t row = m0 + e / BK;
        const int j = j0 + e % BK;
        const bool ok = row < M && j < L;
        if constexpr (FOLD) {
          pa[q] = ok ? ld(row, 1 + j) : T(0);
          pb[q] = ok ? ld(row, nbin - 1 - j) : T(0);
        } else {
          pa[q] = ok ? ld(row, j) : T(0);
        }
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int e = tid + NT * q;
        const int j = j0 + e / BN;
        const int k = k0 + e % BN;
        const bool ok = j < L && k < K;
        pc[q] = ok ? Wc[(int64_t)j * K + k] : T(0);
        ps[q] = ok ? Ws[(int64_t)j * K + k] : T(0);
      }
    };
    fetch(0);
    for (int j0 = 0; j0 < L; j0 += BK) {
      // stage the fetched chunk: the data transposed (BK x BM), the
      // fold sums formed here; the twiddles as they are (BK x BN)
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const int e = tid + NT * q;
        if constexpr (FOLD) {
          As[e % BK][e / BK] = pa[q] + pb[q];
          Ao[e % BK][e / BK] = pa[q] - pb[q];
        } else {
          As[e % BK][e / BK] = pa[q];
        }
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int e = tid + NT * q;
        Bc[e / BN][e % BN] = pc[q];
        Bs[e / BN][e % BN] = ps[q];
      }
      __syncthreads();
      if (j0 + BK < L) fetch(j0 + BK);
      // unroll 4, not 16: measured faster on the H100 (fewer live
      // registers)
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        T a[TM], ao[TM], bc[TN], bs[TN];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          T v[4];
          ld4(&As[c][ty * TM + i], v);
#pragma unroll
          for (int u = 0; u < 4; ++u) a[i + u] = v[u];
          if constexpr (FOLD) {
            ld4(&Ao[c][ty * TM + i], v);
#pragma unroll
            for (int u = 0; u < 4; ++u) ao[i + u] = v[u];
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) ao[i + u] = a[i + u];
          }
        }
        ld4(&Bc[c][tx * TN], bc);
        ld4(&Bs[c][tx * TN], bs);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            accr[i][j] = fma_t(a[i], bc[j], accr[i][j]);
            acci[i][j] = fma_t(ao[i], bs[j], acci[i][j]);
          }
      }
      __syncthreads();
    }

    // epilogue: this tile's harmonics, straight from registers
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = m0 + ty * TM + i;
      if (row >= M) continue;
      T x0 = T(0), xh = T(0);
      if constexpr (FOLD) {
        x0 = ld(row, 0);
        xh = ld(row, nbin / 2);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int k = k0 + tx * TN + j;
        if (k >= K) continue;
        T dr = accr[i][j];
        const T di = acci[i][j];
        if constexpr (FOLD) dr = dr + x0 + xh * sgn[k];
        const int64_t o = row * K + k;
        if constexpr (MODE == SPECTRUM) {
          out_r[o] = dr;
          out_i[o] = di;
        } else {
          const int64_t mo = (row % m_mod) * K + k;
          const T mrv = mr[mo];
          const T miv = mi[mo];
          const T wk = w[(row % w_mod) * K + k];
          out_r[o] = (dr * mrv + di * miv) * wk;
          out_i[o] = (di * mrv - dr * miv) * wk;
          const T m2 = (mrv * mrv + miv * miv) * wk;
          if (want_m2)
            o2[o] = m2;
          else
            s0[i] += m2;
        }
      }
    }
  }

  if (MODE == CROSS && !want_m2) {
    // fixed-order row reduction of the per-thread partial sums
#pragma unroll
    for (int i = 0; i < TM; ++i) red[ty * TM + i][tx] = s0[i];
    __syncthreads();
    if (tid < BM) {
      const int64_t row = m0 + tid;
      if (row < M) {
        T s = T(0);
        for (int t = 0; t < 16; ++t) s += red[tid][t];
        o2[row] = s;
      }
    }
  }
}

// One launch of the float64 SIMT GEMM over M data rows read through ld.
template <typename T, int MODE, class Loader>
int simt_launch(Loader ld, int64_t M, int nbin, const T* Wc, const T* Ws,
                const T* sgn, int L, int K, int fold, const T* mr,
                const T* mi, int64_t m_mod, const T* w, int64_t w_mod,
                T* out_r, T* out_i, T* o2, int want_m2,
                cudaStream_t stream) {
  constexpr int BM = Tile<T>::BM;
  const int nkt = (K + BN - 1) / BN;
  // S0 needs whole rows in one block; every other output is per tile
  const int kt_per_block = (MODE == CROSS && !want_m2) ? nkt : 1;
  dim3 grid((unsigned)((M + BM - 1) / BM),
            (unsigned)((nkt + kt_per_block - 1) / kt_per_block));
  if (fold)
    fcs_kernel<T, true, MODE, Loader><<<grid, NT, 0, stream>>>(
        ld, M, nbin, Wc, Ws, sgn, L, K, kt_per_block, mr, mi, m_mod, w,
        w_mod, out_r, out_i, o2, want_m2);
  else
    fcs_kernel<T, false, MODE, Loader><<<grid, NT, 0, stream>>>(
        ld, M, nbin, Wc, Ws, sgn, L, K, kt_per_block, mr, mi, m_mod, w,
        w_mod, out_r, out_i, o2, want_m2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the three-product TF32 tensor-core GEMM (the head note)

constexpr int TC_NT = 512;        // threads: 16 warps, 4 (rows) x 4 (harmonics)
constexpr int TC_BH = 128;        // harmonics per block (cos + sin: 256 columns)
constexpr int TC_BK = 16;         // time samples per staged chunk (2 k8 steps)
constexpr int TC_LD = TC_BK + 4;  // shared row stride: fragment loads hit 32 banks

// Shared memory of a block with MT m16 tiles per warp (BM = 64 MT rows),
// in floats per stage: A = the split data chunk [plane][row][j], planes
// (hi, lo) of the samples (fold: of the symmetric sums, then hi, lo of
// the antisymmetric ones); B = the twiddle chunk [hi/lo][column][j],
// columns TC_BH cos then TC_BH sin harmonics.  Two stages.
template <int MT, bool FOLD>
struct TcSmem {
  static constexpr int BM = 64 * MT;
  static constexpr int A = (FOLD ? 4 : 2) * BM * TC_LD;
  static constexpr int B = 2 * 2 * TC_BH * TC_LD;
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = 2 * STAGE * (int)sizeof(float);
};

// x rounded to TF32 (10 mantissa bits), nearest with ties away from zero:
// the host builds the twiddles' hi/lo the same way (ops/fourier.py)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x's TF32 (hi, lo) into plane slots p[0] and p[plane]: hi = rna(x),
// lo = rna(x - hi) (x - hi is exact)
__device__ __forceinline__ void tc_split(float x, float* p, int plane) {
  const float h = __uint_as_float(tf32_rna(x));
  p[0] = h;
  p[plane] = __uint_as_float(tf32_rna(x - h));
}

// d += a b on the tensor cores: a 16x8 (row), b 8x8 (col), d 16x8 FP32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x4 TF32 tiles of shared memory into registers (ldmatrix of 8x8
// b16 tiles): lane l gives the address of row l % 8 of tile l / 8 (16
// bytes, 16-byte aligned); register t of lane l holds element (l / 4,
// l % 4) of tile t, the m16n8k8 fragments' (gid, tig)
__device__ __forceinline__ void tc_ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void tc_cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void tc_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void tc_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// grid: (harmonic tiles, row blocks of BM = 64 MT rows); hi/lo: the
// (2, Kp, Lp) cos/sin twiddle planes, Kp = K up to TC_BH, Lp = L up to
// TC_BK, zero-padded.
template <int MODE, int MT, bool FOLD, class Loader>
__global__ void __launch_bounds__(TC_NT, 1) fcs_tc_kernel(
    Loader ld, int64_t M, int nbin, const float* __restrict__ hi,
    const float* __restrict__ lo, const float* __restrict__ sgn, int L,
    int Lp, int Kp, int K, const float* __restrict__ mr,
    const float* __restrict__ mi, int64_t m_mod, const float* __restrict__ w,
    int64_t w_mod, float* __restrict__ out_r, float* __restrict__ out_i,
    float* __restrict__ o2, int want_m2) {
  using S = TcSmem<MT, FOLD>;
  constexpr int BM = S::BM, BK = TC_BK, LD = TC_LD;
  constexpr int NA = BM * BK / TC_NT;  // consecutive samples a thread stages
  constexpr int NB = 2 * 2 * TC_BH * BK / 4 / TC_NT;  // 16-byte copies
  extern __shared__ __align__(16) float tsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row, column
  const int wm = warp >> 2, wn = warp & 3;
  // a 1-D grid, the harmonic tile the fast index: a row block's tiles
  // run side by side and find its rows in L2
  const int nkt = Kp / TC_BH;
  const int kt = (int)(blockIdx.x % (unsigned)nkt);
  const int64_t m0 = (int64_t)(blockIdx.x / (unsigned)nkt) * BM;
  const int k0 = kt * TC_BH;
  const int nch = Lp / BK;
  // programmatic dependent launch: a spectrum launch lets the cross
  // launch after it start at once (its mainloop reads no spectrum); the
  // cross launch waits for the spectrum before its epilogue
  if constexpr (MODE == SPECTRUM)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float accr[MT][4][4], acci[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accr[i][j][e] = 0.f;
        acci[i][j][e] = 0.f;
      }

  // a chunk's samples, fetched into registers a chunk ahead: each
  // thread stages NA consecutive samples of one row, the same row in
  // every chunk (its loader row, with the row's decode constants, is
  // read once)
  const int srow = tid / (BK / NA), sj = (tid % (BK / NA)) * NA;
  const bool srow_ok = m0 + srow < M;
  const auto xrow = ld.at(srow_ok ? m0 + srow : 0);
  float pa[NA], pb[FOLD ? NA : 1];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int j = j0 + sj + q;
      const bool ok = srow_ok && j < L;
      if constexpr (FOLD) {
        pa[q] = ok ? xrow(1 + j) : 0.f;
        pb[q] = ok ? xrow(nbin - 1 - j) : 0.f;
      } else {
        pa[q] = ok ? xrow(j) : 0.f;
      }
    }
  };
  // ... split into (hi, lo) and stored
  auto stage_a = [&](float* st) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int o = srow * LD + sj + q;
      if constexpr (FOLD) {
        tc_split(pa[q] + pb[q], st + o, BM * LD);
        tc_split(pa[q] - pb[q], st + 2 * BM * LD + o, BM * LD);
      } else {
        tc_split(pa[q], st + o, BM * LD);
      }
    }
  };
  // a chunk's twiddles (hi and lo, cos and sin), by cp.async
  auto issue_b = [&](float* st, int j0) {
    float* Bs = st + S::A;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int p = tid + TC_NT * q;
      const int hl = p / (2 * TC_BH * (BK / 4));
      const int col = (p / (BK / 4)) % (2 * TC_BH);
      const int part = p % (BK / 4);
      const float* src =
          (hl ? lo : hi) +
          ((int64_t)(col / TC_BH) * Kp + k0 + col % TC_BH) * Lp + j0 + 4 * part;
      tc_cp_async16(Bs + (hl * 2 * TC_BH + col) * LD + 4 * part, src);
    }
    tc_cp_async_commit();
  };
  // two-stage ring: chunk c + 1's twiddles (cp.async) and samples
  // (registers) are in flight while chunk c is multiplied
  fetch(0);
  issue_b(tsm, 0);
  stage_a(tsm);
  tc_cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    float* cur = tsm + (c & 1) * S::STAGE;
    float* nxt = tsm + ((c + 1) & 1) * S::STAGE;
    if (c + 1 < nch) {
      issue_b(nxt, (c + 1) * BK);
      fetch((c + 1) * BK);
    }
    // the chunk's two k8 steps: per step and per (m16, n8) tile the three
    // products lo hi, hi lo, hi hi into a zeroed fragment, promoted into
    // the FP32 accumulator
    const float* Bs = cur + S::A;
    // ldmatrix rows: lane l addresses row l % 8 of tile l / 8
    const int lrow = lane & 7, ltile = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int kk = 8 * ks;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // cos columns, then sin
        if (half == 0 || FOLD) {  // the samples' (fold: the sums') planes
          const int plane = 2 * half;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // tiles: rows +0 / +8 (tile bit 0) at k + 0 / + 4 (bit 1)
            const int r = wm * 16 * MT + 16 * mt + (ltile & 1) * 8 + lrow;
            const float* ph =
                cur + (plane * BM + r) * LD + kk + (ltile >> 1) * 4;
            tc_ldsm4(ah[mt], ph);
            tc_ldsm4(al[mt], ph + BM * LD);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // tiles: hi k + 0, hi k + 4, lo k + 0, lo k + 4
          const int col = half * TC_BH + wn * 32 + 8 * nt + lrow;
          uint32_t bf[4];
          tc_ldsm4(bf, Bs + ((ltile >> 1) * 2 * TC_BH + col) * LD + kk +
                           (ltile & 1) * 4);
          const uint32_t b_hi[2] = {bf[0], bf[1]};
          const uint32_t b_lo[2] = {bf[2], bf[3]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(t, al[mt], b_hi);
            mma_tf32(t, ah[mt], b_lo);
            mma_tf32(t, ah[mt], b_hi);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (half)
                acci[mt][nt][e] += t[e];
              else
                accr[mt][nt][e] += t[e];
            }
          }
        }
      }
    }
    if (c + 1 < nch) stage_a(nxt);
    tc_cp_async_wait_all();
    __syncthreads();
  }

  if constexpr (MODE == CROSS)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // epilogue: the fragments' (row, harmonic) pairs, straight from
  // registers; c0..c3 of an m16n8 tile sit at (gid, 2 tig), (gid, 2 tig
  // + 1), (gid + 8, 2 tig), (gid + 8, 2 tig + 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t row = m0 + wm * 16 * MT + 16 * mt + gid + 8 * hr;
      if (row >= M) continue;
      float x0 = 0.f, xh = 0.f;
      if constexpr (FOLD) {
        x0 = ld(row, 0);
        xh = ld(row, nbin / 2);
      }
      const int64_t orow = row * K;
      const int64_t mrow = (row % m_mod) * K, wrow = (row % w_mod) * K;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + wn * 32 + 8 * nt + 2 * tig + e;
          if (k >= K) continue;
          float dr = accr[mt][nt][2 * hr + e];
          const float di = acci[mt][nt][2 * hr + e];
          if constexpr (FOLD) dr = dr + x0 + xh * sgn[k];
          if constexpr (MODE == SPECTRUM) {
            out_r[orow + k] = dr;
            out_i[orow + k] = di;
          } else {
            const float mrv = mr[mrow + k];
            const float miv = mi[mrow + k];
            const float wk = w[wrow + k];
            out_r[orow + k] = (dr * mrv + di * miv) * wk;
            out_i[orow + k] = (di * mrv - dr * miv) * wk;
            if (want_m2) o2[orow + k] = (mrv * mrv + miv * miv) * wk;
          }
        }
    }

  if (MODE == CROSS && !want_m2 && kt == 0) {
    // S0 of the block's rows over all K, by the first harmonic tile's
    // block: a warp per row, lane l summing k = l, l + 32, ... in order,
    // then a fixed butterfly
    for (int i = warp; i < BM; i += TC_NT / 32) {
      const int64_t row = m0 + i;
      if (row >= M) break;
      const int64_t mrow = (row % m_mod) * K, wrow = (row % w_mod) * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float mrv = mr[mrow + k];
        const float miv = mi[mrow + k];
        s += (mrv * mrv + miv * miv) * w[wrow + k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) o2[row] = s;
    }
  }
}

template <int MODE, int MT, bool FOLD, class Loader>
int tc_run(dim3 grid, Loader ld, int64_t M, int nbin, const float* hi,
           const float* lo, const float* sgn, int L, int Lp, int Kp, int K,
           const float* mr, const float* mi, int64_t m_mod, const float* w,
           int64_t w_mod, float* out_r, float* out_i, float* o2,
           int want_m2, cudaStream_t stream) {
  auto kern = fcs_tc_kernel<MODE, MT, FOLD, Loader>;
  constexpr int smem = TcSmem<MT, FOLD>::BYTES;
  static int granted[64] = {};
  const cudaError_t e = allow_smem((const void*)kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  // the cross launch may start while the spectrum launch before it runs
  // (griddepcontrol in the kernel orders the spectrum's reads)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = MODE == CROSS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TC_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kern, ld, M, nbin, hi, lo, sgn, L, Lp, Kp, K, mr, mi, m_mod, w,
      w_mod, out_r, out_i, o2, want_m2);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// One launch of the float32 tensor-core GEMM: 128-row blocks for the
// cross-spectrum, 64-row blocks for a spectrum (the template's: few
// rows); hi/lo the host's (2, Kp, Lp) planes.
template <int MODE, class Loader>
int tc_launch(Loader ld, int64_t M, int nbin, const float* hi,
              const float* lo, const float* sgn, int L, int K, int fold,
              const float* mr, const float* mi, int64_t m_mod,
              const float* w, int64_t w_mod, float* out_r, float* out_i,
              float* o2, int want_m2, cudaStream_t stream) {
  constexpr int MT = MODE == CROSS ? 2 : 1;
  constexpr int BM = TcSmem<MT, false>::BM;
  const int Lp = (L + TC_BK - 1) / TC_BK * TC_BK;
  const int Kp = (K + TC_BH - 1) / TC_BH * TC_BH;
  const int64_t nblocks = (M + BM - 1) / BM * (Kp / TC_BH);
  if (L <= 0 || nblocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblocks);
  return fold ? tc_run<MODE, MT, true>(grid, ld, M, nbin, hi, lo, sgn, L, Lp,
                                       Kp, K, mr, mi, m_mod, w, w_mod, out_r,
                                       out_i, o2, want_m2, stream)
              : tc_run<MODE, MT, false>(grid, ld, M, nbin, hi, lo, sgn, L,
                                        Lp, Kp, K, mr, mi, m_mod, w, w_mod,
                                        out_r, out_i, o2, want_m2, stream);
}

// One launch of the GEMM arm over M data rows read through ld: float32
// on the tensor cores (Wc, Ws: the twiddles' hi and lo planes), float64
// on the SIMT GEMM (Wc, Ws: the cos and -sin twiddles).
template <typename T, int MODE, class Loader>
int launch(Loader ld, int64_t M, int nbin, const T* Wc, const T* Ws,
           const T* sgn, int L, int K, int fold, const T* mr,
           const T* mi, int64_t m_mod, const T* w, int64_t w_mod,
           T* out_r, T* out_i, T* o2, int want_m2,
           cudaStream_t stream) {
  if (M <= 0 || K <= 0) return 0;
  if constexpr (std::is_same<T, float>::value)
    return tc_launch<MODE>(ld, M, nbin, Wc, Ws, sgn, L, K, fold, mr, mi,
                           m_mod, w, w_mod, out_r, out_i, o2, want_m2,
                           stream);
  else
    return simt_launch<T, MODE>(ld, M, nbin, Wc, Ws, sgn, L, K, fold, mr, mi,
                                m_mod, w, w_mod, out_r, out_i, o2, want_m2,
                                stream);
}

}  // namespace
