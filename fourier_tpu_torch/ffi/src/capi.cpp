// C ABI for the fourier-tpu native host core.
//
// Same 8-function surface and transform codes 0-4 as the reference's C ABI
// (fourier-ffi/src/lib.rs) so C/C++ consumers of the reference can relink
// against this library unchanged. All exceptions are contained at the
// boundary: creation failures return NULL, transform/destroy failures are
// no-ops (the reference's catch_unwind contract, fourier-ffi/src/lib.rs:18,26).

#include <complex>
#include <cstddef>
#include <memory>
#include <new>

#include "fft_core.hpp"

namespace {

template <typename T>
using Plan = fourier_tpu::FftPlan<T>;

fourier_tpu::Transform to_transform(int code) {
  return static_cast<fourier_tpu::Transform>(code);
}

bool valid_code(int code) { return code >= 0 && code <= 4; }

template <typename T>
Plan<T>* create(std::size_t size) noexcept {
  try {
    auto plan = fourier_tpu::create_plan<T>(size);
    return plan.release();  // may be nullptr for size == 0
  } catch (...) {
    return nullptr;
  }
}

template <typename T, typename C>
void transform_in_place(Plan<T>* plan, C* data, int code) noexcept {
  if (!plan || !data || !valid_code(code)) return;
  try {
    plan->transform_in_place(reinterpret_cast<std::complex<T>*>(data),
                             to_transform(code));
  } catch (...) {
  }
}

template <typename T, typename C>
void transform(Plan<T>* plan, const C* in, C* out, int code) noexcept {
  if (!plan || !in || !out || !valid_code(code)) return;
  try {
    plan->transform(reinterpret_cast<const std::complex<T>*>(in),
                    reinterpret_cast<std::complex<T>*>(out), to_transform(code));
  } catch (...) {
  }
}

}  // namespace

extern "C" {

void* fourier_create_float(std::size_t size) {
  return static_cast<void*>(create<float>(size));
}

void fourier_destroy_float(void* plan) {
  delete static_cast<Plan<float>*>(plan);
}

void fourier_transform_in_place_float(void* plan, float* interleaved,
                                      int transform) {
  transform_in_place(static_cast<Plan<float>*>(plan), interleaved, transform);
}

void fourier_transform_float(void* plan, const float* input, float* output,
                             int transform) {
  ::transform(static_cast<Plan<float>*>(plan), input, output, transform);
}

void* fourier_create_double(std::size_t size) {
  return static_cast<void*>(create<double>(size));
}

void fourier_destroy_double(void* plan) {
  delete static_cast<Plan<double>*>(plan);
}

void fourier_transform_in_place_double(void* plan, double* interleaved,
                                       int transform) {
  transform_in_place(static_cast<Plan<double>*>(plan), interleaved, transform);
}

void fourier_transform_double(void* plan, const double* input, double* output,
                              int transform) {
  ::transform(static_cast<Plan<double>*>(plan), input, output, transform);
}

void fourier_transform_batch_float(void* plan, float* interleaved,
                                   std::size_t batch, int transform) {
  auto* p = static_cast<Plan<float>*>(plan);
  if (!p || !interleaved || !valid_code(transform)) return;
  try {
    for (std::size_t b = 0; b < batch; ++b) {
      p->transform_in_place(
          reinterpret_cast<std::complex<float>*>(interleaved) + b * p->size(),
          to_transform(transform));
    }
  } catch (...) {
  }
}

void fourier_transform_batch_double(void* plan, double* interleaved,
                                    std::size_t batch, int transform) {
  auto* p = static_cast<Plan<double>*>(plan);
  if (!p || !interleaved || !valid_code(transform)) return;
  try {
    for (std::size_t b = 0; b < batch; ++b) {
      p->transform_in_place(
          reinterpret_cast<std::complex<double>*>(interleaved) + b * p->size(),
          to_transform(transform));
    }
  } catch (...) {
  }
}

std::size_t fourier_size_float(void* plan) {
  auto* p = static_cast<Plan<float>*>(plan);
  return p ? p->size() : 0;
}

std::size_t fourier_size_double(void* plan) {
  auto* p = static_cast<Plan<double>*>(plan);
  return p ? p->size() : 0;
}

}  // extern "C"
