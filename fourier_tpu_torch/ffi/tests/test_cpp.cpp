// C++ smoke tests: RAII wrapper + raw C API (the reference's test.cpp
// contract — impulse roundtrip through both interfaces, error < 1e-10).
#include <complex>
#include <cmath>
#include <cstdio>
#include <vector>

#include "fourier_tpu.h"

namespace {

int failures = 0;

void expect(bool cond, const char* what) {
  if (!cond) {
    std::fprintf(stderr, "FAIL: %s\n", what);
    ++failures;
  }
}

void test_wrapper(std::size_t n) {
  fourier_tpu::fft<double> plan(n);
  expect(plan.size() == n, "wrapper size");
  std::vector<std::complex<double>> buf(n, {0.0, 0.0});
  buf[0] = {1.0, 0.0};
  plan.transform_in_place(buf.data(), fourier_tpu::transform::fft);
  for (auto& v : buf) expect(std::abs(v - 1.0) < 1e-10, "impulse spectrum");
  plan.transform_in_place(buf.data(), fourier_tpu::transform::ifft);
  expect(std::abs(buf[0] - 1.0) < 1e-10, "roundtrip dc");
  for (std::size_t i = 1; i < n; ++i)
    expect(std::abs(buf[i]) < 1e-10, "roundtrip zeros");
}

void test_unitary_pair(std::size_t n) {
  fourier_tpu::fft<double> plan(n);
  std::vector<std::complex<double>> x(n), y(n), z(n);
  for (std::size_t i = 0; i < n; ++i)
    x[i] = {std::cos(0.3 * double(i)), std::sin(0.9 * double(i))};
  plan(x.data(), y.data(), fourier_tpu::transform::sqrt_scaled_fft);
  plan(y.data(), z.data(), fourier_tpu::transform::sqrt_scaled_ifft);
  double norm_x = 0, norm_y = 0, err = 0;
  for (std::size_t i = 0; i < n; ++i) {
    norm_x += std::norm(x[i]);
    norm_y += std::norm(y[i]);
    err = std::max(err, std::abs(z[i] - x[i]));
  }
  expect(std::abs(norm_x - norm_y) < 1e-9 * norm_x, "Parseval (unitary)");
  expect(err < 1e-10, "sqrt-scaled roundtrip");
}

void test_raw_c_api(std::size_t n) {
  fourier_fft_float* plan = fourier_create_float(n);
  expect(plan != nullptr, "raw C plan");
  std::vector<std::complex<float>> buf(n, {0.f, 0.f});
  buf[0] = {1.f, 0.f};
  fourier_transform_in_place_float(plan, buf.data(), FOURIER_TRANSFORM_FFT);
  for (auto& v : buf) expect(std::abs(v - 1.f) < 1e-5f, "raw impulse");
  fourier_destroy_float(plan);
}

}  // namespace

int main() {
  test_wrapper(4);
  test_wrapper(48);    // autosort 4*4*3
  test_wrapper(73);    // Bluestein
  test_unitary_pair(96);
  test_unitary_pair(101);
  test_raw_c_api(64);
  if (failures) {
    std::fprintf(stderr, "%d failure(s)\n", failures);
    return 1;
  }
  std::printf("test_cpp: all passed\n");
  return 0;
}
