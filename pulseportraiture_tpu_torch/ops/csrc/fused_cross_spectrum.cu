// Fused windowed DFT -> weighted cross-spectrum for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel fused_cross_spectrum_pallas
// (pulseportraiture_tpu/ops/fused.py).  For every data row r (one
// channel of one subint) and harmonic k < K it writes
//
//   Xr = (dr mr + di mi) w,  Xi = (di mr - dr mi) w,
//   S0[r] = sum_k (mr^2 + mi^2) w     (or the full M2w row)
//
// with (dr, di) the row's rfft and (mr, mi) the model's, never writing
// the four spectra.  Two arms compute it, chosen by a rule on the shape
// (ops/fused.py fft_arm):
//
// - the FFT arm (fft_smem.cuh), for nbin in [16, 8192] with no prime
//   factor above 5 and K <= nbin/2 + 1: a block stages RB rows with
//   cp.async, takes their real mixed-radix FFTs in shared memory two rows
//   per complex transform, and forms the cross-spectrum from the K
//   harmonics it needs.  Bound on this card: bytes (each row, weight and
//   output moved once; the FFT's arithmetic is ~1/50 of the FP32 peak's
//   share of that time), which is what the design aims at;
// - the GEMM arm (fcs_gemm.cuh), for every other shape (an nbin with a
//   prime factor above 5, above 8192 or below 16): the DFT as a matrix
//   product, in float32 three TF32 products per FP32 product on the
//   tensor cores (bound by their rate), in float64 a SIMT GEMM.
//
// Both arms run the model spectrum as a first launch (once per call for
// a shared template) into scratch that the cross launch reads; fold
// (the half-length symmetric DFT) shapes only the GEMM arm.
//
// Plain C interface (ctypes); each entry point launches one kernel on
// the given stream and returns a cudaError_t code.

#include "fcs_gemm.cuh"
#include "fft_smem.cuh"

namespace {

template <typename T, int MODE, bool MIXED>
__global__ void __launch_bounds__(FFT_NT) fft_dense_kernel(
    const T* __restrict__ x, int64_t M, const FftPlan plan,
    const typename Fft<T>::C* __restrict__ tw, int K,
    const T* __restrict__ mr, const T* __restrict__ mi, int64_t m_mod,
    const T* __restrict__ w, int64_t w_mod, T* __restrict__ out_r,
    T* __restrict__ out_i, T* __restrict__ o2, int want_m2) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = typename Fft<T>::C;
  C* buf = reinterpret_cast<C*>(smem);
  T* red = reinterpret_cast<T*>(smem + fft_buffer_bytes<T>(plan.n));
  const int RB = fft_rows_per_block<T>(plan.n);
  const int64_t row0 = (int64_t)blockIdx.x * RB;
  fft_stage_dense<T, MIXED>(buf, x, row0, M, RB, plan);
  fft_dif<T, MIXED>(buf, RB / 2 * plan.n, plan, tw);
  fft_epilogue<T, MODE, MIXED>(buf, row0, M, RB, plan, K, mr, mi, m_mod, w,
                               w_mod, out_r, out_i, o2, want_m2, red);
}

template <typename T, int MODE, bool MIXED>
int fft_dense_run(const FftPlan& plan, const void* x, int64_t M,
                  const void* tw, int K, const void* mr, const void* mi,
                  int64_t m_mod, const void* w, int64_t w_mod, void* out_r,
                  void* out_i, void* o2, int want_m2, void* stream) {
  const int RB = fft_rows_per_block<T>(plan.n);
  const int smem = fft_buffer_bytes<T>(plan.n) + 2 * FFT_NW * (int)sizeof(T);
  auto kern = fft_dense_kernel<T, MODE, MIXED>;
  static int granted[64] = {};  // per kernel and device
  const cudaError_t e = allow_smem((const void*)kern, smem, granted);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)((M + RB - 1) / RB), FFT_NT, smem,
         (cudaStream_t)stream>>>(
      (const T*)x, M, plan, (const typename Fft<T>::C*)tw, K,
      (const T*)mr, (const T*)mi, m_mod, (const T*)w, w_mod, (T*)out_r,
      (T*)out_i, (T*)o2, want_m2);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int fft_dense_launch(const void* x, int64_t M, int nbin, const void* tw,
                     int K, const void* mr, const void* mi, int64_t m_mod,
                     const void* w, int64_t w_mod, void* out_r, void* out_i,
                     void* o2, int want_m2, void* stream) {
  FftPlan plan;
  if (!fft_plan(nbin, plan) || K < 0 || K > nbin / 2 + 1)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  return plan.nodd
             ? fft_dense_run<T, MODE, true>(plan, x, M, tw, K, mr, mi, m_mod,
                                            w, w_mod, out_r, out_i, o2,
                                            want_m2, stream)
             : fft_dense_run<T, MODE, false>(plan, x, M, tw, K, mr, mi,
                                             m_mod, w, w_mod, out_r, out_i,
                                             o2, want_m2, stream);
}

}  // namespace

extern "C" {

// GEMM arm, spectrum mode: (out_r, out_i)[M, K] = windowed DFT of
// x[M, nbin].  float32: hi, lo = the (2, Kp, Lp) TF32 twiddle planes
// (ops/fourier.py "tf32x3"); float64: Wc, Ws = the (L, K) twiddles.
int ppt_fcs_spectrum_f32(const void* x, int64_t M, int nbin,
                         const void* hi, const void* lo, const void* sgn,
                         int L, int K, int fold, void* out_r, void* out_i,
                         void* stream) {
  return launch<float, SPECTRUM>(
      DenseRows<float>{(const float*)x, nbin}, M, nbin, (const float*)hi,
      (const float*)lo, (const float*)sgn, L, K, fold, nullptr, nullptr, 1,
      nullptr, 1, (float*)out_r, (float*)out_i, nullptr, 0,
      (cudaStream_t)stream);
}

int ppt_fcs_spectrum_f64(const void* x, int64_t M, int nbin,
                         const void* Wc, const void* Ws, const void* sgn,
                         int L, int K, int fold, void* out_r, void* out_i,
                         void* stream) {
  return launch<double, SPECTRUM>(
      DenseRows<double>{(const double*)x, nbin}, M, nbin,
      (const double*)Wc, (const double*)Ws, (const double*)sgn, L, K, fold,
      nullptr, nullptr, 1, nullptr, 1, (double*)out_r, (double*)out_i,
      nullptr, 0, (cudaStream_t)stream);
}

// GEMM arm, cross mode: (Xr, Xi)[M, K] and S0[M] (or M2w[M, K] when
// want_m2) from data x[M, nbin], the model spectrum (mr, mi)[*, K] (row
// r % m_mod) and weights w[*, K] (row r % w_mod); the twiddles as the
// spectrum mode's.
int ppt_fcs_cross_f32(const void* x, int64_t M, int nbin, const void* hi,
                      const void* lo, const void* sgn, int L, int K,
                      int fold, const void* mr, const void* mi,
                      int64_t m_mod, const void* w, int64_t w_mod,
                      void* Xr, void* Xi, void* o2,
                      int want_m2, void* stream) {
  return launch<float, CROSS>(
      DenseRows<float>{(const float*)x, nbin}, M, nbin, (const float*)hi,
      (const float*)lo, (const float*)sgn, L, K, fold, (const float*)mr,
      (const float*)mi, m_mod, (const float*)w, w_mod, (float*)Xr,
      (float*)Xi, (float*)o2, want_m2, (cudaStream_t)stream);
}

int ppt_fcs_cross_f64(const void* x, int64_t M, int nbin, const void* Wc,
                      const void* Ws, const void* sgn, int L, int K,
                      int fold, const void* mr, const void* mi,
                      int64_t m_mod, const void* w, int64_t w_mod,
                      void* Xr, void* Xi, void* o2,
                      int want_m2, void* stream) {
  return launch<double, CROSS>(
      DenseRows<double>{(const double*)x, nbin}, M, nbin,
      (const double*)Wc, (const double*)Ws, (const double*)sgn, L, K, fold,
      (const double*)mr, (const double*)mi, m_mod, (const double*)w, w_mod,
      (double*)Xr, (double*)Xi, (double*)o2, want_m2,
      (cudaStream_t)stream);
}

// FFT arm, spectrum mode: (out_r, out_i)[M, K] = the first K harmonics
// of the rfft of x[M, nbin]; tw = the (nbin, 2) twiddle table.
int ppt_fcs_fft_spectrum_f32(const void* x, int64_t M, int nbin,
                             const void* tw, int K, void* out_r,
                             void* out_i, void* stream) {
  return fft_dense_launch<float, FFT_SPECTRUM>(
      x, M, nbin, tw, K, nullptr, nullptr, 1, nullptr, 1, out_r, out_i,
      nullptr, 0, stream);
}

int ppt_fcs_fft_spectrum_f64(const void* x, int64_t M, int nbin,
                             const void* tw, int K, void* out_r,
                             void* out_i, void* stream) {
  return fft_dense_launch<double, FFT_SPECTRUM>(
      x, M, nbin, tw, K, nullptr, nullptr, 1, nullptr, 1, out_r, out_i,
      nullptr, 0, stream);
}

// FFT arm, cross mode: the outputs of ppt_fcs_cross_*.
int ppt_fcs_fft_cross_f32(const void* x, int64_t M, int nbin,
                          const void* tw, int K, const void* mr,
                          const void* mi, int64_t m_mod, const void* w,
                          int64_t w_mod, void* Xr, void* Xi, void* o2,
                          int want_m2, void* stream) {
  return fft_dense_launch<float, FFT_CROSS>(x, M, nbin, tw, K, mr, mi,
                                            m_mod, w, w_mod, Xr, Xi, o2,
                                            want_m2, stream);
}

int ppt_fcs_fft_cross_f64(const void* x, int64_t M, int nbin,
                          const void* tw, int K, const void* mr,
                          const void* mi, int64_t m_mod, const void* w,
                          int64_t w_mod, void* Xr, void* Xi, void* o2,
                          int want_m2, void* stream) {
  return fft_dense_launch<double, FFT_CROSS>(x, M, nbin, tw, K, mr, mi,
                                             m_mod, w, w_mod, Xr, Xi, o2,
                                             want_m2, stream);
}

}  // extern "C"
