// Fused windowed DFT -> weighted cross-spectrum for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel fused_cross_spectrum_pallas
// (pulseportraiture_tpu/ops/fused.py).  The GEMM and its epilogue live
// in fcs_gemm.cuh (shared with fused_decode_cross_spectrum.cu); this
// source reads the data operand from a dense float portrait.
//
// Bound on this card: the contraction is 4 * rows * nbin * K FLOPs on
// rows * nbin inputs, i.e. ~K/2 FLOPs per input byte in float32 —
// far above the H100's FP32 ridge (~20 FLOP/B), so the kernel is
// bound by FP32 FMA throughput (see fcs_gemm.cuh for the design).  The
// model spectrum is one launch of the same kernel in spectrum mode
// (once per call for a shared template), read back in the cross-mode
// epilogue.
//
// Plain C interface (ctypes); each entry point launches one kernel on
// the given stream and returns cudaGetLastError().

#include "fcs_gemm.cuh"

extern "C" {

// Spectrum mode: (out_r, out_i)[M, K] = windowed DFT of x[M, nbin].
int ppt_fcs_spectrum_f32(const void* x, int64_t M, int nbin,
                         const void* Wc, const void* Ws, const void* sgn,
                         int L, int K, int fold, void* out_r, void* out_i,
                         void* stream) {
  return launch<float, SPECTRUM>(
      DenseRows<float>{(const float*)x, nbin}, M, nbin, (const float*)Wc,
      (const float*)Ws, (const float*)sgn, L, K, fold, nullptr, nullptr, 1,
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

// Cross mode: (Xr, Xi)[M, K] and S0[M] (or M2w[M, K] when want_m2)
// from data x[M, nbin], the model spectrum (mr, mi)[*, K] (row
// r % m_mod) and weights w[*, K] (row r % w_mod).
int ppt_fcs_cross_f32(const void* x, int64_t M, int nbin, const void* Wc,
                      const void* Ws, const void* sgn, int L, int K,
                      int fold, const void* mr, const void* mi,
                      int64_t m_mod, const void* w, int64_t w_mod,
                      void* Xr, void* Xi, void* o2,
                      int want_m2, void* stream) {
  return launch<float, CROSS>(
      DenseRows<float>{(const float*)x, nbin}, M, nbin, (const float*)Wc,
      (const float*)Ws, (const float*)sgn, L, K, fold, (const float*)mr,
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

}  // extern "C"
