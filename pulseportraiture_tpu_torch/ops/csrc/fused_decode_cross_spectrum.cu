// Fused sub-byte decode -> windowed DFT -> weighted cross-spectrum for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel fused_decode_cross_spectrum_pallas
// (pulseportraiture_tpu/ops/fused.py).  Per data row r (one channel of
// one subint) it reads bpc = nbin * nbit / 8 packed bytes and computes
// what the Pallas kernel computes on a VMEM-resident decoded tile:
//
//   s_j  = MSB-first nbit-wide sample j (nbit = 1, 2 or 4)
//   x_j  = s_j scl_r + offs_r - b_r,  b_r = least circular-window mean
//          of s scl + offs over round(0.15 nbin) bins
//   x0_r = sum_j x_j,  pwr_r = nbin sum_j (x_j - x0_r / nbin)^2
//          [+ (sum_j x_j (-1)^j)^2 for even nbin]
//   (Xr, Xi, S0) = the cross-spectrum of x against the model, as B1
//
// The Pallas kernel holds a whole decoded (128, nbin) tile in VMEM;
// here that is 1 MB at nbin = 2048, far above an SM's 227 KB.  The
// decode is affine per row, so the work splits in two launches that
// never write the decoded portrait:
//
// 1. stats (one block per row): the row's decoded samples
//    fl(fl(s scl) + offs), their prefix sums in float64 in shared
//    memory, every circular window mean from them and the least of
//    them, b; then x0 and pwr over exactly the samples the GEMM stages,
//    fl(... - b), summed in float64.  The plain version takes the same
//    prefix sums in float64 (ops.noise.min_window_baseline), so the two
//    agree on b; in float32 a 2048-bin scan would lose ~1e-6 of the
//    data scale in b and nbin times that in x0.
// 2. cross: the GEMM of fcs_gemm.cuh with a loader that decodes each
//    sample x_j = s_j scl + offs - b as it stages the data operand,
//    with correctly rounded products and sums (no FMA contraction), so
//    the decoded values equal the plain PyTorch decode's bit for bit
//    given the same b.  The model spectrum comes from B1's spectrum
//    launch (fused_cross_spectrum.cu), once per call.
//
// Bound on this card: the packed bytes are 1/16 of a float32 portrait
// (2-bit), so the GEMM's FP32 FMAs bound it as they bound B1; the stats
// launch reads each packed byte once more.
//
// Plain C interface (ctypes); each entry point launches one kernel on
// the given stream and returns cudaGetLastError().

#include <algorithm>
#include <cmath>

#include "fcs_gemm.cuh"

namespace {

constexpr int ST = 256;  // threads per row of the stats kernel

// correctly rounded products and sums, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// sample j of a packed row: the first sample of a byte sits in its most
// significant bits (the PSRFITS convention)
template <int NBIT>
__device__ __forceinline__ int sample(const uint8_t* __restrict__ rowp,
                                      int j) {
  constexpr int PER = 8 / NBIT;
  const unsigned byte = rowp[j / PER];
  return (int)((byte >> ((PER - 1 - j % PER) * NBIT)) & ((1u << NBIT) - 1u));
}

// the decoded, baselined sample x = s scl + offs - b of a packed row
template <typename T, int NBIT>
struct PackedRows {
  const uint8_t* raw;
  int bpc;
  const T* scl;
  const T* offs;
  const T* base;
  __device__ __forceinline__ T operator()(int64_t row, int j) const {
    const T s = T(sample<NBIT>(raw + row * bpc, j));
    return sub_rn(add_rn(mul_rn(s, scl[row]), offs[row]), base[row]);
  }
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum (or min) of one double per thread, returned to every thread of
// the block; red holds ST / 32 doubles
template <bool MIN>
__device__ __forceinline__ double block_reduce(double v, double* red) {
  v = MIN ? warp_min(v) : warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int k = 1; k < ST / 32; ++k) v = MIN ? fmin(v, red[k]) : v + red[k];
  return v;
}

template <typename T, int NBIT>
__global__ void __launch_bounds__(ST) stats_kernel(
    const uint8_t* __restrict__ raw, int nbin, int bpc, int win,
    const T* __restrict__ scl, const T* __restrict__ offs,
    T* __restrict__ base, T* __restrict__ x0, T* __restrict__ pwr) {
  extern __shared__ double P[];  // inclusive prefix sums of the row
  __shared__ double tpre[ST];
  __shared__ double red[ST / 32];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const T sc = scl[row], of = offs[row];
  const uint8_t* rowp = raw + row * bpc;
  auto affine = [&](int j) {  // the decoded sample before the baseline
    return add_rn(mul_rn(T(sample<NBIT>(rowp, j)), sc), of);
  };

  // each thread owns a contiguous chunk of the row
  const int chunk = (nbin + ST - 1) / ST;
  const int j0 = min(nbin, tid * chunk);
  const int j1 = min(nbin, j0 + chunk);
  double run = 0.0;
  for (int j = j0; j < j1; ++j) {
    run += (double)affine(j);
    P[j] = run;
  }
  // chunk sums -> each chunk's offset (Hillis-Steele inclusive scan)
  tpre[tid] = run;
  __syncthreads();
  for (int off = 1; off < ST; off <<= 1) {
    const double v = tid >= off ? tpre[tid - off] : 0.0;
    __syncthreads();
    tpre[tid] += v;
    __syncthreads();
  }
  const double excl = tpre[tid] - run;
  for (int j = j0; j < j1; ++j) P[j] += excl;
  __syncthreads();

  // the least mean over every circular window of win samples
  const double total = P[nbin - 1];
  double lo = INFINITY;
  for (int t = tid; t < nbin; t += ST) {
    const double before = t ? P[t - 1] : 0.0;
    const int end = t + win - 1;
    const double S = end < nbin ? P[end] - before
                                : total - before + P[end - nbin];
    lo = fmin(lo, S / win);
  }
  const T b = T(block_reduce<true>(lo, red));

  // the Parseval rows of exactly the samples the GEMM stages,
  // x = fl(fl(s scl + offs) - b), summed in float64
  double s1 = 0.0, sa = 0.0;
  for (int j = j0; j < j1; ++j) {
    const double x = (double)sub_rn(affine(j), b);
    s1 += x;
    sa += (j & 1) ? -x : x;
  }
  s1 = block_reduce<false>(s1, red);
  sa = block_reduce<false>(sa, red);
  const double mu = s1 / nbin;
  double s2 = 0.0;
  for (int j = j0; j < j1; ++j) {
    const double d = (double)sub_rn(affine(j), b) - mu;
    s2 += d * d;
  }
  s2 = block_reduce<false>(s2, red);
  if (tid == 0) {
    base[row] = b;
    x0[row] = T(s1);
    pwr[row] = T(nbin * s2 + (nbin % 2 == 0 ? sa * sa : 0.0));
  }
}

template <typename T, int NBIT>
__global__ void decode_kernel(PackedRows<T, NBIT> ld, int64_t M, int nbin,
                              T* __restrict__ out) {
  const int64_t n = M * nbin;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = ld(i / nbin, (int)(i % nbin));
}

template <typename T, int NBIT>
int stats_launch(const uint8_t* raw, int64_t M, int nbin, int bpc, int win,
                 const T* scl, const T* offs, T* base, T* x0, T* pwr,
                 cudaStream_t stream) {
  const size_t smem = (size_t)nbin * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stats_kernel<T, NBIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stats_kernel<T, NBIT><<<(unsigned)M, ST, smem, stream>>>(
      raw, nbin, bpc, win, scl, offs, base, x0, pwr);
  return (int)cudaGetLastError();
}

template <typename T>
int stats(const void* raw, int64_t M, int nbin, int bpc, int nbit, int win,
          const void* scl, const void* offs, void* base, void* x0,
          void* pwr, void* stream) {
  if (M <= 0) return 0;
  const uint8_t* r = (const uint8_t*)raw;
  const T* s = (const T*)scl;
  const T* o = (const T*)offs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nbit) {
    case 1:
      return stats_launch<T, 1>(r, M, nbin, bpc, win, s, o, (T*)base,
                                (T*)x0, (T*)pwr, st);
    case 2:
      return stats_launch<T, 2>(r, M, nbin, bpc, win, s, o, (T*)base,
                                (T*)x0, (T*)pwr, st);
    case 4:
      return stats_launch<T, 4>(r, M, nbin, bpc, win, s, o, (T*)base,
                                (T*)x0, (T*)pwr, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int cross(const void* raw, int64_t M, int nbin, int bpc, int nbit,
          const void* scl, const void* offs, const void* base,
          const void* Wc, const void* Ws, const void* sgn, int L, int K,
          int fold, const void* mr, const void* mi, int64_t m_mod,
          const void* w, int64_t w_mod, void* Xr, void* Xi, void* S0,
          void* stream) {
  const uint8_t* r = (const uint8_t*)raw;
  const T* s = (const T*)scl;
  const T* o = (const T*)offs;
  const T* b = (const T*)base;
#define PPT_FDCS_CROSS(NB)                                                 \
  return launch<T, CROSS>(PackedRows<T, NB>{r, bpc, s, o, b}, M, nbin,     \
                          (const T*)Wc, (const T*)Ws, (const T*)sgn, L, K, \
                          fold, (const T*)mr, (const T*)mi, m_mod,         \
                          (const T*)w, w_mod, (T*)Xr, (T*)Xi, (T*)S0, 0,   \
                          (cudaStream_t)stream)
  switch (nbit) {
    case 1: PPT_FDCS_CROSS(1);
    case 2: PPT_FDCS_CROSS(2);
    case 4: PPT_FDCS_CROSS(4);
  }
#undef PPT_FDCS_CROSS
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int decode(const void* raw, int64_t M, int nbin, int bpc, int nbit,
           const void* scl, const void* offs, const void* base, void* out,
           void* stream) {
  if (M <= 0) return 0;
  const uint8_t* r = (const uint8_t*)raw;
  const T* s = (const T*)scl;
  const T* o = (const T*)offs;
  const T* b = (const T*)base;
  const int64_t n = M * nbin;
  const unsigned grid = (unsigned)std::min<int64_t>((n + 255) / 256, 1 << 20);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nbit) {
    case 1:
      decode_kernel<T, 1><<<grid, 256, 0, st>>>(
          PackedRows<T, 1>{r, bpc, s, o, b}, M, nbin, (T*)out);
      break;
    case 2:
      decode_kernel<T, 2><<<grid, 256, 0, st>>>(
          PackedRows<T, 2>{r, bpc, s, o, b}, M, nbin, (T*)out);
      break;
    case 4:
      decode_kernel<T, 4><<<grid, 256, 0, st>>>(
          PackedRows<T, 4>{r, bpc, s, o, b}, M, nbin, (T*)out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Stats: per row of raw[M, bpc], the baseline base[M] and the Parseval
// rows x0[M], pwr[M].
int ppt_fdcs_stats_f32(const void* raw, int64_t M, int nbin, int bpc,
                       int nbit, int win, const void* scl, const void* offs,
                       void* base, void* x0, void* pwr, void* stream) {
  return stats<float>(raw, M, nbin, bpc, nbit, win, scl, offs, base, x0,
                      pwr, stream);
}

int ppt_fdcs_stats_f64(const void* raw, int64_t M, int nbin, int bpc,
                       int nbit, int win, const void* scl, const void* offs,
                       void* base, void* x0, void* pwr, void* stream) {
  return stats<double>(raw, M, nbin, bpc, nbit, win, scl, offs, base, x0,
                       pwr, stream);
}

// Cross: (Xr, Xi)[M, K] and S0[M] from the packed rows decoded with
// scl/offs/base[M], the model spectrum (mr, mi)[*, K] (row r % m_mod)
// and weights w[*, K] (row r % w_mod).
int ppt_fdcs_cross_f32(const void* raw, int64_t M, int nbin, int bpc,
                       int nbit, const void* scl, const void* offs,
                       const void* base, const void* Wc, const void* Ws,
                       const void* sgn, int L, int K, int fold,
                       const void* mr, const void* mi, int64_t m_mod,
                       const void* w, int64_t w_mod, void* Xr, void* Xi,
                       void* S0, void* stream) {
  return cross<float>(raw, M, nbin, bpc, nbit, scl, offs, base, Wc, Ws,
                      sgn, L, K, fold, mr, mi, m_mod, w, w_mod, Xr, Xi, S0,
                      stream);
}

int ppt_fdcs_cross_f64(const void* raw, int64_t M, int nbin, int bpc,
                       int nbit, const void* scl, const void* offs,
                       const void* base, const void* Wc, const void* Ws,
                       const void* sgn, int L, int K, int fold,
                       const void* mr, const void* mi, int64_t m_mod,
                       const void* w, int64_t w_mod, void* Xr, void* Xi,
                       void* S0, void* stream) {
  return cross<double>(raw, M, nbin, bpc, nbit, scl, offs, base, Wc, Ws,
                       sgn, L, K, fold, mr, mi, m_mod, w, w_mod, Xr, Xi, S0,
                       stream);
}

// Decode: out[M, nbin] = the samples the cross launch stages (the
// kernel's own decode, for checking it against the plain version).
int ppt_fdcs_decode_f32(const void* raw, int64_t M, int nbin, int bpc,
                        int nbit, const void* scl, const void* offs,
                        const void* base, void* out, void* stream) {
  return decode<float>(raw, M, nbin, bpc, nbit, scl, offs, base, out,
                       stream);
}

int ppt_fdcs_decode_f64(const void* raw, int64_t M, int nbin, int bpc,
                        int nbit, const void* scl, const void* offs,
                        const void* base, void* out, void* stream) {
  return decode<double>(raw, M, nbin, bpc, nbit, scl, offs, base, out,
                        stream);
}

}  // extern "C"
