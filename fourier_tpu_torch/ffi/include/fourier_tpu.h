/* fourier-tpu C/C++ interface.
 *
 * Dual-language header mirroring the surface of the reference's
 * fourier-ffi/include/fourier.h: a C99 API over opaque plan pointers with
 * transform codes 0-4, plus a header-only C++11 RAII wrapper. Function names
 * and codes are ABI-compatible with the reference so existing consumers can
 * relink unchanged.
 *
 * Complex data is interleaved (re, im) pairs: C99 `_Complex`, C++
 * `std::complex`, or a bare float/double array of length 2*n — all share the
 * same layout.
 */
#ifndef FOURIER_TPU_H_
#define FOURIER_TPU_H_

#include <stddef.h>

#ifdef __cplusplus
#include <complex>
typedef std::complex<float> fourier_complex_float;
typedef std::complex<double> fourier_complex_double;
extern "C" {
#else
#include <complex.h>
typedef float _Complex fourier_complex_float;
typedef double _Complex fourier_complex_double;
#endif

/* Transform codes (match fourier_tpu_torch.Transform and the reference ABI). */
typedef enum fourier_transform {
  FOURIER_TRANSFORM_FFT = 0,
  FOURIER_TRANSFORM_IFFT = 1,
  FOURIER_TRANSFORM_UNSCALED_IFFT = 2,
  FOURIER_TRANSFORM_SQRT_SCALED_FFT = 3,
  FOURIER_TRANSFORM_SQRT_SCALED_IFFT = 4
} fourier_transform;

/* Opaque plan handles. */
typedef void fourier_fft_float;
typedef void fourier_fft_double;

/* Create a plan for n-point complex transforms. Returns NULL on failure
 * (n == 0 or allocation failure). */
fourier_fft_float* fourier_create_float(size_t n);
fourier_fft_double* fourier_create_double(size_t n);

/* Destroy a plan (NULL is a no-op). */
void fourier_destroy_float(fourier_fft_float* plan);
void fourier_destroy_double(fourier_fft_double* plan);

/* Transform n interleaved complex values in place. */
void fourier_transform_in_place_float(fourier_fft_float* plan,
                                      fourier_complex_float* data,
                                      int transform);
void fourier_transform_in_place_double(fourier_fft_double* plan,
                                       fourier_complex_double* data,
                                       int transform);

/* Out-of-place transform (input is untouched). */
void fourier_transform_float(fourier_fft_float* plan,
                             const fourier_complex_float* input,
                             fourier_complex_float* output, int transform);
void fourier_transform_double(fourier_fft_double* plan,
                              const fourier_complex_double* input,
                              fourier_complex_double* output, int transform);

/* Plan size accessors. */
size_t fourier_size_float(fourier_fft_float* plan);
size_t fourier_size_double(fourier_fft_double* plan);

/* Transform `batch` contiguous rows of n interleaved complex values in
 * place (row-major (batch, n) buffer). One boundary crossing for a whole
 * batch — the batched-regime entry point (beyond the reference ABI). */
void fourier_transform_batch_float(fourier_fft_float* plan,
                                   fourier_complex_float* data, size_t batch,
                                   int transform);
void fourier_transform_batch_double(fourier_fft_double* plan,
                                    fourier_complex_double* data, size_t batch,
                                    int transform);

#ifdef __cplusplus
} /* extern "C" */

/* ------------------------------------------------------------------------
 * Header-only C++ RAII wrapper (the fourier::fft<T> analog,
 * fourier.h:72-128 in the reference).
 * ---------------------------------------------------------------------- */
#include <cstddef>
#include <memory>
#include <stdexcept>

namespace fourier_tpu {

enum class transform : int {
  fft = FOURIER_TRANSFORM_FFT,
  ifft = FOURIER_TRANSFORM_IFFT,
  unscaled_ifft = FOURIER_TRANSFORM_UNSCALED_IFFT,
  sqrt_scaled_fft = FOURIER_TRANSFORM_SQRT_SCALED_FFT,
  sqrt_scaled_ifft = FOURIER_TRANSFORM_SQRT_SCALED_IFFT,
};

template <typename T>
class fft;

template <>
class fft<float> {
 public:
  explicit fft(std::size_t n)
      : plan_(fourier_create_float(n), &fourier_destroy_float) {
    if (!plan_) throw std::runtime_error("fourier_tpu: plan creation failed");
  }
  std::size_t size() const { return fourier_size_float(plan_.get()); }
  void transform_in_place(std::complex<float>* data,
                          transform t = transform::fft) {
    fourier_transform_in_place_float(plan_.get(), data, static_cast<int>(t));
  }
  void operator()(const std::complex<float>* in, std::complex<float>* out,
                  transform t = transform::fft) {
    fourier_transform_float(plan_.get(), in, out, static_cast<int>(t));
  }

 private:
  std::unique_ptr<void, void (*)(void*)> plan_;
};

template <>
class fft<double> {
 public:
  explicit fft(std::size_t n)
      : plan_(fourier_create_double(n), &fourier_destroy_double) {
    if (!plan_) throw std::runtime_error("fourier_tpu: plan creation failed");
  }
  std::size_t size() const { return fourier_size_double(plan_.get()); }
  void transform_in_place(std::complex<double>* data,
                          transform t = transform::fft) {
    fourier_transform_in_place_double(plan_.get(), data, static_cast<int>(t));
  }
  void operator()(const std::complex<double>* in, std::complex<double>* out,
                  transform t = transform::fft) {
    fourier_transform_double(plan_.get(), in, out, static_cast<int>(t));
  }

 private:
  std::unique_ptr<void, void (*)(void*)> plan_;
};

}  // namespace fourier_tpu

#endif /* __cplusplus */
#endif /* FOURIER_TPU_H_ */
