/* C smoke tests for the fourier-tpu C ABI.
 *
 * Impulse FFT->IFFT roundtrip under 1e-10 plus a naive-DFT spot check —
 * the reference's FFI test contract (fourier-ffi/test.c semantics).
 */
#include <complex.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>

#include "fourier_tpu.h"

static int check(int cond, const char* what) {
  if (!cond) {
    fprintf(stderr, "FAIL: %s\n", what);
    return 1;
  }
  return 0;
}

static int test_impulse_roundtrip(size_t n) {
  int failures = 0;
  fourier_fft_double* plan = fourier_create_double(n);
  failures += check(plan != NULL, "plan creation");
  failures += check(fourier_size_double(plan) == n, "plan size");
  double _Complex* buf = malloc(n * sizeof(double _Complex));
  for (size_t i = 0; i < n; ++i) buf[i] = (i == 0) ? 1.0 : 0.0;
  fourier_transform_in_place_double(plan, buf, FOURIER_TRANSFORM_FFT);
  /* FFT of an impulse is all ones. */
  for (size_t i = 0; i < n; ++i) {
    failures += check(cabs(buf[i] - 1.0) < 1e-10, "impulse spectrum");
  }
  fourier_transform_in_place_double(plan, buf, FOURIER_TRANSFORM_IFFT);
  for (size_t i = 0; i < n; ++i) {
    double _Complex want = (i == 0) ? 1.0 : 0.0;
    failures += check(cabs(buf[i] - want) < 1e-10, "roundtrip");
  }
  free(buf);
  fourier_destroy_double(plan);
  return failures;
}

static int test_vs_naive_dft(size_t n) {
  int failures = 0;
  fourier_fft_float* plan = fourier_create_float(n);
  failures += check(plan != NULL, "f32 plan creation");
  float _Complex* in = malloc(n * sizeof(float _Complex));
  float _Complex* out = malloc(n * sizeof(float _Complex));
  for (size_t i = 0; i < n; ++i) {
    in[i] = (float)cos(0.7 * (double)i) + I * (float)sin(1.3 * (double)i + 0.5);
  }
  fourier_transform_float(plan, in, out, FOURIER_TRANSFORM_FFT);
  for (size_t k = 0; k < n; ++k) {
    double _Complex acc = 0;
    for (size_t j = 0; j < n; ++j) {
      double theta = -2.0 * M_PI * (double)(j * k) / (double)n;
      acc += (cos(theta) + I * sin(theta)) *
             ((double)crealf(in[j]) + I * (double)cimagf(in[j]));
    }
    failures += check(cabs((double)crealf(out[k]) + I * (double)cimagf(out[k]) -
                           acc) < 1e-3,
                      "naive DFT comparison");
  }
  free(in);
  free(out);
  fourier_destroy_float(plan);
  return failures;
}

int main(void) {
  int failures = 0;
  failures += test_impulse_roundtrip(4);    /* reference's n=4 gate */
  failures += test_impulse_roundtrip(64);   /* autosort */
  failures += test_impulse_roundtrip(73);   /* prime -> Bluestein */
  failures += test_vs_naive_dft(24);
  failures += test_vs_naive_dft(100);
  failures += check(fourier_create_float(0) == NULL, "size 0 returns NULL");
  fourier_destroy_float(NULL); /* NULL-safe */
  if (failures) {
    fprintf(stderr, "%d failure(s)\n", failures);
    return 1;
  }
  printf("test_c: all passed\n");
  return 0;
}
