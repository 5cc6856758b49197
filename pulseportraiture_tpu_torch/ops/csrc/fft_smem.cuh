// A real FFT of any 5-smooth length n (n = 2^a 3^b 5^c) on rows held in
// shared memory, and the windowed cross-spectrum epilogue built on it:
// the FFT arm of the fused kernels B1 (fused_cross_spectrum.cu) and B2
// (fused_decode_cross_spectrum.cu).
//
// Replaces, inside those kernels, the DFT that the TPU Pallas kernels
// fused_cross_spectrum_pallas and fused_decode_cross_spectrum_pallas
// (pulseportraiture_tpu/ops/fused.py) run as a matmul on the MXU.
//
// Bound on this card: bytes.  A real FFT of an n-bin row costs
// ~2.5 n log2 n FLOPs, against 4 n K for the matmul DFT (56x fewer at
// n = 2048, K = 384), so the function is bound by reading the rows and
// weights once and writing the K windowed harmonics once.  The design
// keeps everything between those two in shared memory:
//
// - Two real rows per complex transform.  Rows 2g and 2g+1 of a block
//   form z = x + i y (interleaved re/im), so one complex FFT serves two
//   rows; X_k = (Z_k + conj Z_{(n-k) % n}) / 2 and Y_k = (Z_k - conj
//   Z_{(n-k) % n}) / (2i) are split out for k < K only (K <= n/2 + 1, DC
//   and, for even n, Nyquist included).  An odd row count pairs the lone
//   last row with zeros.
// - In-place decimation-in-frequency mixed-radix Cooley-Tukey.  The host
//   factors n into a pass plan (fft_plan, a small struct passed to the
//   kernel by value): the radix-3 passes, then the radix-5 passes, then
//   radix 8 while three factors of 2 remain and one radix-4 or radix-2
//   pass (2048 = 8 8 8 4, 1000 = 5 5 5 8, 1536 = 3 8 8 8, 3072 = 3 8 8 8
//   2).  The odd radices go first so that the power-of-two passes run on
//   power-of-two sub-blocks, where the padding below was tuned; with
//   them last, the padding costs the final radix-5 pass 4.6 wavefronts
//   per ideal one at n = 1000 in float32 (simulated).  Each butterfly
//   reads and writes the same R slots, so a pass needs one barrier after
//   it and no second buffer.  The output is in mixed-radix digit-reversed
//   order; fft_pos() maps a frequency to its slot by walking the plan,
//   and the epilogue reads through it.  Each kernel is built twice: with
//   the radix-3/5 code (MIXED) and, for a power-of-two n, without it, so
//   that n keeps the registers and the time it had before the odd
//   radices (one build for both cost B2 6 % at 2048 bins on the H100,
//   tools/fft_arm_ab.py).  A radix-3/5 butterfly's (block,
//   offset) comes from a multiply-high by the plan's ceil(2^32 / m),
//   exact for the block's < 2^16 values; the power-of-two passes, whose
//   strides are powers of two, and their digits in fft_pos keep the
//   shifts and masks of a power-of-two n.
// - Sign convention of ops.fourier._rfft_weights: Re X_k = sum x cos,
//   Im X_k = -sum x sin (the forward transform, exp(-2 pi i jk / n)).
// - Twiddles from a host table of exp(-2 pi i j / n), j < n, computed in
//   float64 and cast to T (ops.fourier device_weights kind "fft"), read
//   through the read-only cache.  A radix-8 butterfly at offset t reads
//   w^t, w^2t and w^4t and forms w^3t, w^5t, w^6t, w^7t as products of
//   two table values, a radix-4 one forms w^3t; radix 3 and 5 read each
//   w^qt from the table.  The butterflies' own constants (1/sqrt 2,
//   sqrt(3)/2, cos and sin of 2 pi/5 and 4 pi/5) are double literals
//   cast to T; no __sinf/__cosf anywhere.
// - Bank conflicts: complex slot i lives at i + (i >> P) + (i >> 7),
//   P = log2 of the complex values in 128 bytes (4 in float32, 3 in
//   float64).  The first pad breaks the power-of-two strides of the
//   butterfly passes, the second those of the digit-reversed reads of
//   the epilogue.  Simulated per half-warp (float32, 8-byte slots) or
//   quarter-warp (float64), wavefronts per ideal one, pass by pass
//   (tests/test_torch_fft.py carries the simulator):
//     n = 2048  f32 1.0 1.0 2.0 1.0        f64 1.0 (every pass)
//     n = 1000  f32 1.42 1.52 2.0 1.0      f64 1.0
//     n = 1536  f32 1.0 1.0 2.0 1.0        f64 1.0
//     n = 3072  f32 1.0 1.0 1.0 2.0 1.0    f64 1.0
//     n = 1125  f32 1.88 1.89 1.93 1.85 4.56   f64 1.65-1.90 (odd n:
//               no power-of-two pass, the padding only hurts it)
//   so the padding stays as it was; the epilogue's gathers at K = 384:
//   2.3 / 2.4 (f32 / f64) at 2048, 2.4 / 2.8 at 1000, 2.0 / 3.5 at 1536,
//   2.0 / 3.0 at 3072.
// - A block owns RB = 2 p rows, p the largest power of two with p n <= E
//   (1 when n >= E), E = 4096 complex values in float32 and 2048 in
//   float64: 35 KB of shared memory at n = 2048, so several blocks share
//   an SM and one block's loads overlap another's passes.  n = 8192 in
//   float64 takes 149 KB (one block per SM), the most of any supported
//   n.  A power of two keeps the epilogue's row pairs an even split of
//   its warps (every warp of a pair's group reaches its barrier) and B2's
//   stat groups a power of two threads wide, at any n.
//
// The epilogue gives each complex row one or more warps (its harmonics
// across the lanes, so Xr/Xi/w/mr/mi are read and written coalesced;
// one split of Z_k, Z_{n-k} serves both real rows) and reduces S0 in a
// fixed order (warp butterfly, then the row's warps in index order),
// with no atomics.
//
// Shape rule (ops/fused.py fft_arm): nbin in [FFT_MIN_N, FFT_MAX_N] =
// [16, 8192] with no prime factor other than 2, 3 and 5, and K <= nbin/2
// + 1, in float32 and float64.  Every other shape takes the GEMM arm
// (fcs_gemm.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage in every source that includes this header, as
// fcs_gemm.cuh.
namespace {

constexpr int FFT_NT = 256;  // threads per block
constexpr int FFT_NW = FFT_NT / 32;
constexpr int FFT_MIN_N = 16;
constexpr int FFT_MAX_N = 8192;
constexpr int FFT_MAX_PASSES = 8;  // 6561 = 3^8 and 4374 = 3^7 2 take 8

enum FftMode { FFT_SPECTRUM = 0, FFT_CROSS = 1 };

template <typename T>
struct Fft;
template <>
struct Fft<float> {
  using C = float2;
  static constexpr int ELEMS = 4096;  // complex values per block, n <= ELEMS
  static constexpr int PAD = 4;       // log2 complex values per 128 bytes
};
template <>
struct Fft<double> {
  using C = double2;
  static constexpr int ELEMS = 2048;
  static constexpr int PAD = 3;
};

// shared-memory slot of complex value i
template <typename T>
__host__ __device__ __forceinline__ int fft_phys(int i) {
  return i + (i >> Fft<T>::PAD) + (i >> 7);
}

// rows per block: two real rows per complex transform, and a power of
// two, so that the epilogue's warps split the row pairs evenly and B2's
// stats run in groups of a power of two threads: 2 p, p the largest power
// of two <= ELEMS / n (1 when n >= ELEMS)
template <typename T>
__host__ __device__ __forceinline__ int fft_rows_per_block(int n) {
  int q = Fft<T>::ELEMS / n;  // then the largest power of two <= q
  q |= q >> 1;
  q |= q >> 2;
  q |= q >> 4;
  q |= q >> 8;
  return q ? 2 * (q - (q >> 1)) : 2;
}

// bytes of the complex buffer of a block (16-byte multiple)
template <typename T>
__host__ __device__ __forceinline__ int fft_buffer_bytes(int n) {
  const int E = fft_rows_per_block<T>(n) / 2 * n;
  const int b = (fft_phys<T>(E - 1) + 1) * (int)sizeof(typename Fft<T>::C);
  return (b + 15) & ~15;
}

// Allow kernel `kern` `smem` bytes of dynamic shared memory on the
// current device, calling cudaFuncSetAttribute only when a request
// exceeds what that device already grants it (the default 48 KB, or an
// earlier request recorded in the caller's `granted`, one per kernel).
inline cudaError_t allow_smem(const void* kern, int smem,
                              int (&granted)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* g = dev < 64 ? &granted[dev] : nullptr;
  if (smem <= 48 * 1024 || (g && smem <= *g)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && g) *g = smem;
  return e;
}

// One pass of the plan: radix r over sub-blocks of span L = r m; the
// butterfly at offset a < m reads slots a + j m of its sub-block and
// multiplies output q by tw[a q s], s = n / L.  A radix-3 or radix-5
// pass finds u / m by a multiply-high, magic = ceil(2^32 / m) (0 for
// m = 1); a power-of-two pass, whose m is a power of two, by a shift,
// magic = log2 m.
struct FftPass {
  int r, m, s;
  unsigned magic;
};

// The pass plan of a length-n FFT, built on the host and passed to the
// kernel by value: np passes, the first nodd of them radix 3 or 5, then
// the power-of-two passes over the span 2^lg2 (n's power-of-two part);
// magic = ceil(2^32 / n).
struct FftPlan {
  int n, np, nodd, lg2;
  unsigned magic;
  FftPass pass[FFT_MAX_PASSES];
};

inline unsigned fft_magic(int d) {
  return d > 1 ? (unsigned)((0x100000000ull + (unsigned)d - 1u) / (unsigned)d)
               : 0u;
}

// The plan of n: the radix-3 passes, the radix-5 passes, radix 8 while
// three factors of 2 remain, then one radix-4 or radix-2 pass.  False
// (and no plan) for n outside [FFT_MIN_N, FFT_MAX_N] or with a prime
// factor above 5.
inline bool fft_plan(int n, FftPlan& plan) {
  if (n < FFT_MIN_N || n > FFT_MAX_N) return false;
  int e[3] = {0, 0, 0}, q = n;
  const int primes[3] = {2, 3, 5};
  for (int i = 0; i < 3; ++i)
    while (q % primes[i] == 0) {
      q /= primes[i];
      ++e[i];
    }
  if (q != 1) return false;
  int radix[FFT_MAX_PASSES], np = 0;
  const int total = e[1] + e[2] + e[0] / 3 + (e[0] % 3 ? 1 : 0);
  if (total > FFT_MAX_PASSES) return false;
  for (int i = 0; i < e[1]; ++i) radix[np++] = 3;
  for (int i = 0; i < e[2]; ++i) radix[np++] = 5;
  for (int i = 0; i < e[0] / 3; ++i) radix[np++] = 8;
  if (e[0] % 3) radix[np++] = 1 << (e[0] % 3);
  plan.n = n;
  plan.np = np;
  plan.nodd = e[1] + e[2];
  plan.lg2 = e[0];
  plan.magic = fft_magic(n);
  int L = n;
  for (int p = 0; p < np; ++p) {
    const int m = L / radix[p];
    int lm = 0;
    while ((1 << lm) < m) ++lm;
    plan.pass[p] = FftPass{radix[p], m, n / L,
                           p < plan.nodd ? fft_magic(m) : (unsigned)lm};
    L = m;
  }
  return true;
}

// u / d for 0 <= u < 2^16 and 1 <= d < 2^16, magic = fft_magic(d)
__device__ __forceinline__ int fft_div(int u, int d, unsigned magic) {
  return d == 1 ? u : (int)__umulhi((unsigned)u, magic);
}

template <class C>
__device__ __forceinline__ C cadd(C a, C b) {
  return C{a.x + b.x, a.y + b.y};
}
template <class C>
__device__ __forceinline__ C csub(C a, C b) {
  return C{a.x - b.x, a.y - b.y};
}
template <class C>
__device__ __forceinline__ C cmul(C a, C b) {
  return C{a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
template <class C>
__device__ __forceinline__ C mul_mi(C a) {  // a * (-i)
  return C{a.y, -a.x};
}

// the forward DFT of R values in registers, natural order out
template <class C>
__device__ __forceinline__ void dft2(C (&v)[2]) {
  const C a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <class C>
__device__ __forceinline__ void dft4(C (&v)[4]) {
  const C a0 = cadd(v[0], v[2]), a2 = csub(v[0], v[2]);
  const C a1 = cadd(v[1], v[3]), a3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(a0, a1);
  v[2] = csub(a0, a1);
  v[1] = cadd(a2, a3);
  v[3] = csub(a2, a3);
}

template <class C>
__device__ __forceinline__ void dft8(C (&v)[8]) {
  using T = decltype(v[0].x);
  const T h = T(0.70710678118654752440);  // 1/sqrt(2)
  // radix-2 stages of span 8, 4, 2 (decimation in frequency)
  const C a0 = cadd(v[0], v[4]), d0 = csub(v[0], v[4]);
  const C a1 = cadd(v[1], v[5]), d1 = csub(v[1], v[5]);
  const C a2 = cadd(v[2], v[6]), d2 = csub(v[2], v[6]);
  const C a3 = cadd(v[3], v[7]), d3 = csub(v[3], v[7]);
  const C a4 = d0;
  const C a5 = C{(d1.x + d1.y) * h, (d1.y - d1.x) * h};   // * (1 - i)/sqrt2
  const C a6 = mul_mi(d2);
  const C a7 = C{(d3.y - d3.x) * h, -(d3.x + d3.y) * h};  // * (-1 - i)/sqrt2
  const C b0 = cadd(a0, a2), b2 = csub(a0, a2);
  const C b1 = cadd(a1, a3), b3 = mul_mi(csub(a1, a3));
  const C b4 = cadd(a4, a6), b6 = csub(a4, a6);
  const C b5 = cadd(a5, a7), b7 = mul_mi(csub(a5, a7));
  // the radix-2 network leaves frequency k at position bitrev3(k)
  v[0] = cadd(b0, b1);
  v[4] = csub(b0, b1);
  v[2] = cadd(b2, b3);
  v[6] = csub(b2, b3);
  v[1] = cadd(b4, b5);
  v[5] = csub(b4, b5);
  v[3] = cadd(b6, b7);
  v[7] = csub(b6, b7);
}

template <class C>
__device__ __forceinline__ void dft3(C (&v)[3]) {
  using T = decltype(v[0].x);
  const T h = T(0.5), s3 = T(0.86602540378443864676);  // sqrt(3)/2
  const C t1 = cadd(v[1], v[2]), t2 = csub(v[1], v[2]);
  const C a = C{v[0].x - h * t1.x, v[0].y - h * t1.y};
  const C b = C{s3 * t2.y, -s3 * t2.x};  // -i sqrt(3)/2 t2
  v[0] = cadd(v[0], t1);
  v[1] = cadd(a, b);
  v[2] = csub(a, b);
}

template <class C>
__device__ __forceinline__ void dft5(C (&v)[5]) {
  using T = decltype(v[0].x);
  const T c1 = T(0.30901699437494742410);   // cos(2 pi / 5)
  const T c2 = T(-0.80901699437494742410);  // cos(4 pi / 5)
  const T s1 = T(0.95105651629515357212);   // sin(2 pi / 5)
  const T s2 = T(0.58778525229247312917);   // sin(4 pi / 5)
  const C t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const C d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const C a1 = C{v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y};
  const C a2 = C{v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y};
  const C b1 = mul_mi(C{s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y});
  const C b2 = mul_mi(C{s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y});
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(a1, b1);
  v[4] = csub(a1, b1);
  v[2] = cadd(a2, b2);
  v[3] = csub(a2, b2);
}

// One radix-R pass over the block's E complex values, every sub-block of
// span L = R m: butterfly (blk, a) reads slots blk L + a + j m,
// transforms them, multiplies output j by W_L^(a j) = tw[a j n / L] and
// writes them back to the same slots.
template <typename T, int R>
__device__ __forceinline__ void dif_pass(typename Fft<T>::C* buf, int E,
                                         const FftPass& ps,
                                         const typename Fft<T>::C* tw) {
  using C = typename Fft<T>::C;
  const int m = ps.m;
  for (int u = threadIdx.x; u < E / R; u += FFT_NT) {
    int blk, a;
    if constexpr (R == 3 || R == 5) {
      blk = fft_div(u, m, ps.magic);
      a = u - blk * m;
    } else {
      blk = u >> ps.magic;
      a = u & (m - 1);
    }
    const int base = blk * R * m + a;
    C v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = buf[fft_phys<T>(base + j * m)];
    if constexpr (R == 8) {
      dft8(v);
    } else if constexpr (R == 5) {
      dft5(v);
    } else if constexpr (R == 4) {
      dft4(v);
    } else if constexpr (R == 3) {
      dft3(v);
    } else {
      dft2(v);
    }
    if (m > 1) {
      const int t = a * ps.s;
      const C w1 = __ldg(tw + t);
      v[1] = cmul(v[1], w1);
      if constexpr (R == 3 || R == 5) {
#pragma unroll
        for (int q = 2; q < R; ++q) v[q] = cmul(v[q], __ldg(tw + q * t));
      } else if constexpr (R != 2) {
        const C w2 = __ldg(tw + 2 * t);
        const C w3 = cmul(w1, w2);
        v[2] = cmul(v[2], w2);
        v[3] = cmul(v[3], w3);
        if constexpr (R == 8) {
          const C w4 = __ldg(tw + 4 * t);
          v[4] = cmul(v[4], w4);
          v[5] = cmul(v[5], cmul(w1, w4));
          v[6] = cmul(v[6], cmul(w2, w4));
          v[7] = cmul(v[7], cmul(w3, w4));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) buf[fft_phys<T>(base + j * m)] = v[j];
  }
}

// In-place forward FFT of every length-n row of the block's E complex
// values (rows contiguous), pass by pass as the plan says.  MIXED false
// (a plan with no radix-3/5 pass, a power-of-two n) compiles the
// power-of-two passes alone.  Call after a barrier; returns after one.
template <typename T, bool MIXED>
__device__ void fft_dif(typename Fft<T>::C* buf, int E, const FftPlan& plan,
                        const typename Fft<T>::C* tw) {
  for (int p = 0; p < plan.np; ++p) {
    const FftPass& ps = plan.pass[p];
    if constexpr (MIXED) {
      if (ps.r == 3 || ps.r == 5) {
        if (ps.r == 3)
          dif_pass<T, 3>(buf, E, ps, tw);
        else
          dif_pass<T, 5>(buf, E, ps, tw);
        __syncthreads();
        continue;
      }
    }
    if (ps.r == 8)
      dif_pass<T, 8>(buf, E, ps, tw);
    else if (ps.r == 4)
      dif_pass<T, 4>(buf, E, ps, tw);
    else
      dif_pass<T, 2>(buf, E, ps, tw);
    __syncthreads();
  }
}

// the slot of frequency k in a transformed row: the mixed-radix digit
// reversal of the plan (the first pass's radix takes k's lowest digit,
// which lands at its stride m): the radix-3 and radix-5 passes' digits
// (MIXED only), then the power-of-two passes' 3-bit digits and a 1- or
// 2-bit one
template <bool MIXED>
__device__ __forceinline__ int fft_pos(int k, const FftPlan& plan) {
  int pos = 0;
  if constexpr (MIXED) {
#pragma unroll
    for (int p = 0; p < FFT_MAX_PASSES; ++p) {
      if (p >= plan.nodd) break;
      const int r = plan.pass[p].r;
      const int q = r == 3 ? k / 3 : k / 5;
      pos += (k - q * r) * plan.pass[p].m;
      k = q;
    }
  }
  int L = 1 << plan.lg2;
  for (int p = 0; p < plan.lg2 / 3; ++p) {
    L >>= 3;
    pos += (k & 7) * L;
    k >>= 3;
  }
  const int rem = plan.lg2 % 3;
  if (rem) pos += (k & ((1 << rem) - 1)) * (L >> rem);
  return pos;
}

// harmonic k of the real rows 2g and 2g + 1 of the block (g0 = g n):
// the two-for-one split of complex row g
template <typename T, bool MIXED>
__device__ __forceinline__ void fft_split(const typename Fft<T>::C* buf,
                                          int g0, const FftPlan& plan, int k,
                                          T& xr, T& xi, T& yr, T& yi) {
  using C = typename Fft<T>::C;
  const C zk = buf[fft_phys<T>(g0 + fft_pos<MIXED>(k, plan))];
  // the mirror (n - k) % n
  const C zc =
      buf[fft_phys<T>(g0 + fft_pos<MIXED>(k ? plan.n - k : 0, plan))];
  xr = (zk.x + zc.x) * T(0.5);
  xi = (zk.y - zc.y) * T(0.5);
  yr = (zk.y + zc.y) * T(0.5);
  yi = (zc.x - zk.x) * T(0.5);
}

// cp.async copies of one element, device memory -> shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage rows row0 .. row0 + RB - 1 of a dense (M, n) array into the
// block's buffer (real row 2g + h -> the re (h = 0) or im (h = 1) part
// of complex row g), zeros past M.  Ends with a barrier.
template <typename T, bool MIXED>
__device__ void fft_stage_dense(typename Fft<T>::C* buf, const T* x,
                                int64_t row0, int64_t M, int RB,
                                const FftPlan& plan) {
  const int n = plan.n;
  for (int e = threadIdx.x; e < RB * n; e += FFT_NT) {
    const int r = MIXED ? (int)__umulhi((unsigned)e, plan.magic)
                        : e >> plan.lg2;
    const int j = e - r * n;
    T* dst = &buf[fft_phys<T>((r >> 1) * n + j)].x + (r & 1);
    if (row0 + r < M)
      cp_async<sizeof(T)>(dst, x + (row0 + r) * n + j);
    else
      *dst = T(0);
  }
  cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ float warp_sum_t(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum_t(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One output harmonic k of a data row: o = row K, mo and wo its model
// and weight rows' offsets.
template <typename T, int MODE>
__device__ __forceinline__ void fft_emit(int64_t o, int64_t mo, int64_t wo,
                                         int k, T dr, T di,
                                         const T* __restrict__ mr,
                                         const T* __restrict__ mi,
                                         const T* __restrict__ w,
                                         T* __restrict__ out_r,
                                         T* __restrict__ out_i,
                                         T* __restrict__ o2, int want_m2,
                                         T& acc) {
  if constexpr (MODE == FFT_SPECTRUM) {
    out_r[o + k] = dr;
    out_i[o + k] = di;
  } else {
    const T mrv = mr[mo + k], miv = mi[mo + k], wk = w[wo + k];
    out_r[o + k] = (dr * mrv + di * miv) * wk;
    out_i[o + k] = (di * mrv - dr * miv) * wk;
    const T m2 = (mrv * mrv + miv * miv) * wk;
    if (want_m2)
      o2[o + k] = m2;
    else
      acc += m2;
  }
}

// The epilogue on the block's transformed rows.  FFT_SPECTRUM: (out_r,
// out_i)[row, k] = the spectrum.  FFT_CROSS: (Xr, Xi)[row, k] and S0[row]
// (or M2w[row, k] when want_m2) against (mr, mi)[row % m_mod, k] and
// w[row % w_mod, k].  One or more warps take a complex row, its
// harmonics across the lanes, and emit both of its real rows from one
// split.  red holds 2 FFT_NW values of T.  Every thread of the block
// must call it.
template <typename T, int MODE, bool MIXED>
__device__ void fft_epilogue(const typename Fft<T>::C* buf, int64_t row0,
                             int64_t M, int RB, const FftPlan& plan, int K,
                             const T* __restrict__ mr,
                             const T* __restrict__ mi, int64_t m_mod,
                             const T* __restrict__ w, int64_t w_mod,
                             T* __restrict__ out_r, T* __restrict__ out_i,
                             T* __restrict__ o2, int want_m2, T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npair = RB / 2;
  const int wpp = npair >= FFT_NW ? 1 : FFT_NW / npair;  // warps per pair
  const int sub = warp % wpp;
  for (int g = warp / wpp; g < npair; g += FFT_NW / wpp) {
    const int64_t row = row0 + 2 * g;  // and row + 1
    T acc0 = T(0), acc1 = T(0);
    if (row < M) {
      const bool two = row + 1 < M;
      const int64_t o0 = row * K, o1 = o0 + K;
      const int64_t mo0 = (row % m_mod) * K, mo1 = ((row + 1) % m_mod) * K;
      const int64_t wo0 = (row % w_mod) * K, wo1 = ((row + 1) % w_mod) * K;
      for (int k = sub * 32 + lane; k < K; k += wpp * 32) {
        T xr, xi, yr, yi;
        fft_split<T, MIXED>(buf, g * plan.n, plan, k, xr, xi, yr, yi);
        fft_emit<T, MODE>(o0, mo0, wo0, k, xr, xi, mr, mi, w, out_r, out_i,
                          o2, want_m2, acc0);
        if (two)
          fft_emit<T, MODE>(o1, mo1, wo1, k, yr, yi, mr, mi, w, out_r, out_i,
                            o2, want_m2, acc1);
      }
    }
    if (MODE == FFT_CROSS && !want_m2) {
      acc0 = warp_sum_t(acc0);
      acc1 = warp_sum_t(acc1);
      if (wpp == 1) {
        if (lane == 0 && row < M) o2[row] = acc0;
        if (lane == 0 && row + 1 < M) o2[row + 1] = acc1;
      } else {  // one pair per warp group: every warp passes here once
        if (lane == 0) {
          red[2 * warp] = acc0;
          red[2 * warp + 1] = acc1;
        }
        __syncthreads();
        if (sub == 0 && lane < 2 && row + lane < M) {
          T s = T(0);
          for (int q = 0; q < wpp; ++q) s += red[2 * (warp + q) + lane];
          o2[row + lane] = s;
        }
      }
    }
  }
}

}  // namespace
