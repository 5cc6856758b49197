// The windowed-DFT -> cross-spectrum GEMM shared by the two fused
// kernels (fused_cross_spectrum.cu, fused_decode_cross_spectrum.cu): the
// GEMM arm of the ports of the TPU Pallas kernels
// fused_cross_spectrum_pallas and fused_decode_cross_spectrum_pallas
// (pulseportraiture_tpu/ops/fused.py), which carries the DFT on the MXU
// as this GEMM does in FP32 FMAs.
//
// Shape rule between the arms (ops/fused.py fft_arm): this arm takes
// every shape the FFT arm (fft_smem.cuh) does not, i.e. nbin not a power
// of two in [16, 8192] or K > nbin/2 + 1.  Bound on this card: FP32 FMA
// throughput (4 rows nbin K FLOPs on rows nbin inputs, ~K/2 FLOPs per
// input byte, far above the H100's FP32 ridge of ~20 FLOP/B); the design
// below keeps the FMA pipes fed.
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
// packed loader decodes sub-byte samples as it stages them, so the
// decoded portrait never reaches device memory.
//
// Design (no tensor cores: dft_precision 'highest' asks for full FP32
// products): a register-tiled SIMT GEMM.  A block owns a (16 TM)-row x
// 64-harmonic output tile; each of its 256 threads accumulates a
// TM-row x 4-harmonic sub-tile of BOTH the cos and the sin product in
// registers (TM = 8 in float32, 4 in float64), over 16-sample time
// chunks staged in shared memory.  A thread's rows and harmonics are
// contiguous in shared memory, so each time step costs a few 16-byte
// shared loads for 2 * TM * 4 FMAs.  The next chunk is fetched from
// device memory into registers while the current one is multiplied.
// The data chunk is stored transposed (padded against bank conflicts);
// in fold mode the symmetric and antisymmetric sums are formed while
// staging.  The cross-spectrum is formed in the epilogue from
// registers.  S0 needs the whole harmonic row: in cross mode a block
// walks all harmonic tiles of its rows and reduces the per-thread
// partial sums in shared memory in a fixed order, with no atomics, so
// results are reproducible run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage in every source that includes this header: each
// kernel library instantiates and registers its own copies.
namespace {

constexpr int BN = 64;   // harmonics per tile
constexpr int BK = 16;   // time samples per staged chunk
constexpr int TN = 4;    // harmonics per thread (contiguous)
constexpr int NT = 256;  // threads per block (16 x 16)

// rows per thread: 8 in float32, 4 in float64 (register budget)
template <typename T>
struct Tile {
  static constexpr int TM = sizeof(T) == 4 ? 8 : 4;
  static constexpr int BM = 16 * TM;   // rows per block
  static constexpr int LDA = BM + 4;   // padded row stride of As
};

enum Mode { SPECTRUM = 0, CROSS = 1 };

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// four contiguous, 16-byte aligned shared-memory values
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
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

// One launch of the GEMM over M data rows read through ld.
template <typename T, int MODE, class Loader>
int launch(Loader ld, int64_t M, int nbin, const T* Wc, const T* Ws,
           const T* sgn, int L, int K, int fold, const T* mr,
           const T* mi, int64_t m_mod, const T* w, int64_t w_mod,
           T* out_r, T* out_i, T* o2, int want_m2,
           cudaStream_t stream) {
  if (M <= 0 || K <= 0) return 0;
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

}  // namespace
