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
// Every arm decodes a sample as fl(fl(fl(s scl) + offs) - b) with
// correctly rounded products and sums (no FMA contraction), so the
// decoded values equal the plain PyTorch decode's bit for bit given the
// same b; b comes from float64 prefix sums of fl(fl(s scl) + offs) and
// the least window mean (row_baseline), and x0 and pwr are summed in
// float64 over exactly the staged samples (row_parseval).  The plain
// version takes the same prefix sums in float64
// (ops.noise.min_window_baseline), so the two agree on b; in float32 a
// 2048-bin scan would lose ~1e-6 of the data scale in b and nbin times
// that in x0.  Two arms, by the rule on the shape of ops/fused.py
// fft_arm (as B1's):
//
// - the FFT arm, one pass per row block (fft_decode_kernel): after the
//   template's spectrum (B1's FFT spectrum launch, once per call), one
//   kernel copies its RB rows' packed bytes into shared memory (each
//   byte read once: 16-byte cp.async when the block's bytes start and
//   end on 16-byte boundaries, else a byte a thread), takes the rows'
//   baselines there, several rows at once, one group of threads each
//   (their float64 prefix arrays overlay the complex buffer until b is
//   known; a pad slot after each thread's chunk keeps the chunks' sums
//   off one bank),
//   decodes the rows into the buffer with x0 and pwr, runs the
//   shared-memory FFT of fft_smem.cuh and B1's epilogue.  The decoded
//   portrait never leaves shared memory.  Bound on this card: bytes (the
//   packed rows are 1/16 of a float32 portrait at 2 bits, so the weights
//   and the K-harmonic outputs dominate);
// - the GEMM arm, every other shape: a stats launch (one block per row,
//   the same row_baseline and row_parseval), B1's GEMM spectrum launch,
//   and the GEMM of fcs_gemm.cuh with a loader that decodes each sample
//   as it stages it (float32: three TF32 products on the tensor cores,
//   bound by their rate; float64: the SIMT GEMM).
//
// Plain C interface (ctypes); each entry point launches one kernel on
// the given stream and returns a cudaError_t code.

#include <algorithm>
#include <cmath>

#include "fcs_gemm.cuh"
#include "fft_smem.cuh"

namespace {

constexpr int ST = FFT_NT;  // threads of a block working on one row's stats

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
  // one row's samples, its decode constants read once: at(row)(j) =
  // (*this)(row, j)
  struct Row {
    const uint8_t* p;
    T sc, of, b;
    __device__ __forceinline__ T operator()(int j) const {
      return sub_rn(add_rn(mul_rn(T(sample<NBIT>(p, j)), sc), of), b);
    }
  };
  __device__ __forceinline__ Row at(int64_t row) const {
    return {raw + row * bpc, scl[row], offs[row], base[row]};
  }
};

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or min) of one double per thread over each group of G threads
// (G a multiple of 32 dividing ST; the block's groups reduce together),
// returned to every thread of the group; red holds ST / 32 doubles.
// The group's warps are added in index order.  Every thread of the block
// must call it.
template <bool MIN>
__device__ __forceinline__ double group_reduce(double v, double* red,
                                               int G) {
  v = MIN ? warp_min(v) : warp_sum_t(v);
  __syncthreads();  // red may still be read from the previous call
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int w0 = warp & ~(G / 32 - 1);
  v = red[w0];
  for (int k = 1; k < G / 32; ++k)
    v = MIN ? fmin(v, red[w0 + k]) : v + red[w0 + k];
  return v;
}

// the decoded sample before the baseline, fl(fl(s scl) + offs)
template <typename T, int NBIT>
__device__ __forceinline__ T affine(const uint8_t* rowp, int j, T sc,
                                    T of) {
  return add_rn(mul_rn(T(sample<NBIT>(rowp, j)), sc), of);
}

// f(j, a) for the samples j0 <= j < j1 of a packed row, a = fl(fl(s scl)
// + offs): a byte at a time (one shared-memory load per byte) when the
// range is whole bytes, else a sample at a time; the same values either
// way.
template <typename T, int NBIT, class F>
__device__ __forceinline__ void for_affine(const uint8_t* rowp, int j0,
                                           int j1, T sc, T of, F f) {
  constexpr int PER = 8 / NBIT;
  if ((j0 | j1) % PER == 0) {
    for (int q = j0 / PER; q < j1 / PER; ++q) {
      const unsigned byte = rowp[q];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const unsigned s =
            (byte >> ((PER - 1 - u) * NBIT)) & ((1u << NBIT) - 1u);
        f(q * PER + u, add_rn(mul_rn(T(s), sc), of));
      }
    }
  } else {
    for (int j = j0; j < j1; ++j) f(j, affine<T, NBIT>(rowp, j, sc, of));
  }
}

// Doubles of a row's prefix array for a group of G threads: each
// thread's chunk of ceil(nbin / G) sums is followed by one pad slot, so
// the threads' chunks start in different banks.
__host__ __device__ __forceinline__ int prefix_doubles(int nbin, int G) {
  const int chunk = (nbin + G - 1) / G;
  return nbin + nbin / chunk + 1;
}

// The row's baseline b, by the G threads of a group (every thread of the
// block calls it, each group on its own row): inclusive float64 prefix
// sums P of the decoded samples (each thread a contiguous chunk; the
// chunks' offsets by a warp scan and the group's warp totals in index
// order), every circular window sum from them, and the least one over
// win: min_t fl(S_t / win) = fl(min_t S_t / win), division being
// monotone.  P holds prefix_doubles(nbin, G) doubles of shared memory
// (sum j at j + j / chunk), red ST / 32.
template <typename T, int NBIT>
__device__ T row_baseline(const uint8_t* rowp, int nbin, int win, T sc,
                          T of, double* P, double* red, int G) {
  const int gtid = threadIdx.x & (G - 1), lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, w0 = warp & ~(G / 32 - 1);
  const unsigned chunk = (nbin + G - 1) / G;
  const int j0 = min(nbin, gtid * (int)chunk);
  const int j1 = min(nbin, j0 + (int)chunk);
  double* Pc = P + gtid;  // sum j of this chunk at Pc[j]
  double run = 0.0;
  for_affine<T, NBIT>(rowp, j0, j1, sc, of, [&](int j, T a) {
    run += (double)a;
    Pc[j] = run;
  });
  double v = run;  // inclusive scan of the chunk sums within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  double excl = __shfl_up_sync(0xffffffffu, v, 1);
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 31) red[warp] = v;
  __syncthreads();
  double off = 0.0;
  for (int q = w0; q < warp; ++q) off += red[q];
  excl = lane ? off + excl : off;
  for (int j = j0; j < j1; ++j) Pc[j] += excl;
  __syncthreads();

  // the least sum over every circular window of win samples
  const bool pow2 = (chunk & (chunk - 1)) == 0;  // at a power-of-two nbin
  const int cs = __ffs(chunk) - 1;
  auto at = [&](unsigned j) { return P[j + (pow2 ? j >> cs : j / chunk)]; };
  const double total = at(nbin - 1);
  double lo = INFINITY;
  for (int t = gtid; t < nbin; t += G) {
    const double before = t ? at(t - 1) : 0.0;
    const int end = t + win - 1;
    lo = fmin(lo, end < nbin ? at(end) - before
                             : total - before + at(end - nbin));
  }
  return T(group_reduce<true>(lo, red, G) / win);
}

// The Parseval rows of the staged samples x = fl(fl(s scl + offs) - b),
// summed in float64 by the G threads of a group (every thread of the
// block calls it), each thread a contiguous chunk, in one pass: x0 =
// sum x, pwr = nbin (sum x^2 - x0 mu) [+ (sum x (-1)^j)^2], the
// mean-removed power without a second pass (the samples are baselined,
// so sum x^2 is within a small factor of the centred sum and float64
// keeps its digits).  put(j, x) sees each sample once.
template <typename T, int NBIT, class Put>
__device__ void row_parseval(const uint8_t* rowp, int nbin, T sc, T of, T b,
                             double* red, int G, double& x0, double& pwr,
                             Put put) {
  const int chunk = (nbin + G - 1) / G;
  const int j0 = min(nbin, (int)(threadIdx.x & (G - 1)) * chunk);
  const int j1 = min(nbin, j0 + chunk);
  double s1 = 0.0, sa = 0.0, q = 0.0;
  for_affine<T, NBIT>(rowp, j0, j1, sc, of, [&](int j, T a) {
    const T x = sub_rn(a, b);
    put(j, x);
    const double d = (double)x;
    s1 += d;
    sa += (j & 1) ? -d : d;
    q = fma(d, d, q);
  });
  s1 = group_reduce<false>(s1, red, G);
  sa = group_reduce<false>(sa, red, G);
  q = group_reduce<false>(q, red, G);
  x0 = s1;
  pwr = nbin * (q - s1 * (s1 / nbin)) + (nbin % 2 == 0 ? sa * sa : 0.0);
}

// GEMM arm: one block per row, the baseline and the Parseval rows
template <typename T, int NBIT>
__global__ void __launch_bounds__(ST) stats_kernel(
    const uint8_t* __restrict__ raw, int nbin, int bpc, int win,
    const T* __restrict__ scl, const T* __restrict__ offs,
    T* __restrict__ base, T* __restrict__ x0, T* __restrict__ pwr) {
  extern __shared__ double P[];  // inclusive prefix sums of the row
  __shared__ double red[ST / 32];
  const int64_t row = blockIdx.x;
  const T sc = scl[row], of = offs[row];
  const uint8_t* rowp = raw + row * bpc;
  const T b = row_baseline<T, NBIT>(rowp, nbin, win, sc, of, P, red, ST);
  double s1, pw;
  row_parseval<T, NBIT>(rowp, nbin, sc, of, b, red, ST, s1, pw,
                        [](int, T) {});
  if (threadIdx.x == 0) {
    base[row] = b;
    x0[row] = T(s1);
    pwr[row] = T(pw);
  }
}

// Rows of a block whose stats run at once, a group of FFT_NT / ng
// threads each: all of the block's rows, up to one per warp (measured on
// the H100: the fewer barrier rounds outweigh the larger prefix arrays,
// which at 2048 bins in float32 leave room for 3 blocks per SM).
template <typename T>
__host__ __device__ __forceinline__ int fft_stat_rows(int n) {
  const int RB = fft_rows_per_block<T>(n);
  return RB < FFT_NW ? RB : FFT_NW;
}

// Shared-memory bytes of fft_decode_kernel before the packed rows: the
// complex buffer, overlaid until the baselines are known by the float64
// prefix arrays of the rows whose stats run at once (the larger of the
// two).
template <typename T>
__host__ __device__ __forceinline__ int fft_decode_front(int n) {
  const int ng = fft_stat_rows<T>(n);
  const int p = ((ng * prefix_doubles(n, FFT_NT / ng) * 8) + 15) & ~15;
  const int b = fft_buffer_bytes<T>(n);
  return p > b ? p : b;
}

// ... and after them: the reduction scratch, the baselines and the
// epilogue's reduction
template <typename T>
__host__ __device__ __forceinline__ int fft_decode_extra(int RB, int bpc) {
  return ((RB * bpc + 15) & ~15) + (ST / 32) * 8 + RB * (int)sizeof(T) +
         2 * FFT_NW * (int)sizeof(T);
}

// FFT arm: one pass per block of RB rows
template <typename T, int NBIT, bool MIXED>
__global__ void __launch_bounds__(FFT_NT) fft_decode_kernel(
    const uint8_t* __restrict__ raw, int64_t M, const FftPlan plan, int bpc,
    int win, const T* __restrict__ scl, const T* __restrict__ offs,
    const typename Fft<T>::C* __restrict__ tw, int K,
    const T* __restrict__ mr, const T* __restrict__ mi, int64_t m_mod,
    const T* __restrict__ w, int64_t w_mod, T* __restrict__ Xr,
    T* __restrict__ Xi, T* __restrict__ S0, T* __restrict__ x0,
    T* __restrict__ pwr) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = typename Fft<T>::C;
  C* buf = reinterpret_cast<C*>(smem);
  const int n = plan.n;
  const int RB = fft_rows_per_block<T>(n);
  uint8_t* bytes = smem + fft_decode_front<T>(n);
  double* red = reinterpret_cast<double*>(bytes + ((RB * bpc + 15) & ~15));
  T* bsh = reinterpret_cast<T*>(red + ST / 32);
  T* tred = bsh + RB;
  const int64_t row0 = (int64_t)blockIdx.x * RB;
  const int nrows = (int)(M - row0 < RB ? M - row0 : RB);
  // the rows' stats run ng at a time, one group of G threads each; a
  // group past the last row repeats row 0's arithmetic and keeps nothing
  const int ng = fft_stat_rows<T>(n), G = FFT_NT / ng;
  const int grp = threadIdx.x / G, gtid = threadIdx.x & (G - 1);
  double* P = reinterpret_cast<double*>(smem) + grp * prefix_doubles(n, G);

  // 1. the rows' packed bytes, read once
  const uint8_t* src = raw + row0 * bpc;
  const int nbytes = nrows * bpc;
  if (((uintptr_t)src & 15) == 0 && (nbytes & 15) == 0) {
    for (int i = threadIdx.x * 16; i < nbytes; i += FFT_NT * 16)
      cp_async<16>(bytes + i, src + i);
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < nbytes; i += FFT_NT) bytes[i] = src[i];
  }
  __syncthreads();

  // 2. each row's baseline, its prefix sums in the buffer's space
  for (int r0 = 0; r0 < RB; r0 += ng) {
    const int r = r0 + grp, rr = r < nrows ? r : 0;
    const T b = row_baseline<T, NBIT>(bytes + rr * bpc, n, win,
                                      scl[row0 + rr], offs[row0 + rr], P,
                                      red, G);
    if (gtid == 0) bsh[r] = b;
  }
  __syncthreads();

  // 3. the decoded, baselined rows into the buffer (real row 2g + h ->
  //    the re or im part of complex row g; zeros past the last row),
  //    with x0 and pwr
  for (int r0 = 0; r0 < RB; r0 += ng) {
    const int r = r0 + grp, rr = r < nrows ? r : 0;
    const bool live = r < nrows;
    T* row_slots = &buf[0].x + (r & 1);
    const int g0 = (r >> 1) * n;
    auto put = [&](int j, T x) {
      row_slots[2 * fft_phys<T>(g0 + j)] = live ? x : T(0);
    };
    double s1, pw;
    row_parseval<T, NBIT>(bytes + rr * bpc, n, scl[row0 + rr],
                          offs[row0 + rr], bsh[rr], red, G, s1, pw, put);
    if (live && gtid == 0) {
      x0[row0 + r] = T(s1);
      pwr[row0 + r] = T(pw);
    }
  }
  __syncthreads();

  // 4. the rows' FFTs and B1's epilogue
  fft_dif<T, MIXED>(buf, RB / 2 * n, plan, tw);
  fft_epilogue<T, FFT_CROSS, MIXED>(buf, row0, M, RB, plan, K, mr, mi,
                                    m_mod, w, w_mod, Xr, Xi, S0, 0, tred);
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
  const size_t smem = (size_t)prefix_doubles(nbin, ST) * sizeof(double);
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

template <typename T, int NBIT, bool MIXED>
int fft_decode_launch(const uint8_t* raw, int64_t M, const FftPlan& plan,
                      int bpc, int win, const T* scl, const T* offs,
                      const typename Fft<T>::C* tw, int K, const T* mr,
                      const T* mi, int64_t m_mod, const T* w, int64_t w_mod,
                      T* Xr, T* Xi, T* S0, T* x0, T* pwr,
                      cudaStream_t stream) {
  const int RB = fft_rows_per_block<T>(plan.n);
  const int smem = fft_decode_front<T>(plan.n) + fft_decode_extra<T>(RB, bpc);
  auto kern = fft_decode_kernel<T, NBIT, MIXED>;
  static int granted[64] = {};  // per kernel and device
  const cudaError_t e = allow_smem((const void*)kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)((M + RB - 1) / RB), FFT_NT, smem, stream>>>(
      raw, M, plan, bpc, win, scl, offs, tw, K, mr, mi, m_mod, w, w_mod, Xr,
      Xi, S0, x0, pwr);
  return (int)cudaGetLastError();
}

template <typename T>
int fft_decode(const void* raw, int64_t M, int nbin, int bpc, int nbit,
               int win, const void* scl, const void* offs, const void* tw,
               int K, const void* mr, const void* mi, int64_t m_mod,
               const void* w, int64_t w_mod, void* Xr, void* Xi, void* S0,
               void* x0, void* pwr, void* stream) {
  FftPlan plan;
  if (!fft_plan(nbin, plan) || K < 0 || K > nbin / 2 + 1)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
#define PPT_FDCS_FFT(NB, MX)                                                \
  fft_decode_launch<T, NB, MX>(                                             \
      (const uint8_t*)raw, M, plan, bpc, win, (const T*)scl,                \
      (const T*)offs, (const typename Fft<T>::C*)tw, K, (const T*)mr,       \
      (const T*)mi, m_mod, (const T*)w, w_mod, (T*)Xr, (T*)Xi, (T*)S0,      \
      (T*)x0, (T*)pwr, (cudaStream_t)stream)
  switch (nbit) {
    case 1: return plan.nodd ? PPT_FDCS_FFT(1, true) : PPT_FDCS_FFT(1, false);
    case 2: return plan.nodd ? PPT_FDCS_FFT(2, true) : PPT_FDCS_FFT(2, false);
    case 4: return plan.nodd ? PPT_FDCS_FFT(4, true) : PPT_FDCS_FFT(4, false);
  }
#undef PPT_FDCS_FFT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// GEMM arm, stats: per row of raw[M, bpc], the baseline base[M] and the
// Parseval rows x0[M], pwr[M].
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

// GEMM arm, cross: (Xr, Xi)[M, K] and S0[M] from the packed rows
// decoded with scl/offs/base[M], the model spectrum (mr, mi)[*, K] (row
// r % m_mod) and weights w[*, K] (row r % w_mod).  float32: hi, lo = the
// (2, Kp, Lp) TF32 twiddle planes; float64: Wc, Ws = the (L, K)
// twiddles.
int ppt_fdcs_cross_f32(const void* raw, int64_t M, int nbin, int bpc,
                       int nbit, const void* scl, const void* offs,
                       const void* base, const void* hi, const void* lo,
                       const void* sgn, int L, int K, int fold,
                       const void* mr, const void* mi, int64_t m_mod,
                       const void* w, int64_t w_mod, void* Xr, void* Xi,
                       void* S0, void* stream) {
  return cross<float>(raw, M, nbin, bpc, nbit, scl, offs, base, hi, lo,
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

// Decode: out[M, nbin] = the samples both arms stage (the kernels' own
// decode, for checking it against the plain version).
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

// FFT arm: (Xr, Xi, S0, x0, pwr) of the packed rows raw[M, bpc] against
// the model spectrum (mr, mi)[*, K] (row r % m_mod) and weights w[*, K]
// (row r % w_mod), in one launch; tw = the (nbin, 2) twiddle table.
int ppt_fdcs_fft_f32(const void* raw, int64_t M, int nbin, int bpc, int nbit,
                     int win, const void* scl, const void* offs,
                     const void* tw, int K, const void* mr, const void* mi,
                     int64_t m_mod, const void* w, int64_t w_mod, void* Xr,
                     void* Xi, void* S0, void* x0, void* pwr, void* stream) {
  return fft_decode<float>(raw, M, nbin, bpc, nbit, win, scl, offs, tw, K,
                           mr, mi, m_mod, w, w_mod, Xr, Xi, S0, x0, pwr,
                           stream);
}

int ppt_fdcs_fft_f64(const void* raw, int64_t M, int nbin, int bpc, int nbit,
                     int win, const void* scl, const void* offs,
                     const void* tw, int K, const void* mr, const void* mi,
                     int64_t m_mod, const void* w, int64_t w_mod, void* Xr,
                     void* Xi, void* S0, void* x0, void* pwr, void* stream) {
  return fft_decode<double>(raw, M, nbin, bpc, nbit, win, scl, offs, tw, K,
                            mr, mi, m_mod, w, w_mod, Xr, Xi, S0, x0, pwr,
                            stream);
}

}  // extern "C"
