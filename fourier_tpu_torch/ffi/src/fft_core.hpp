// fourier-tpu native host core: planner + mixed-radix Stockham + Bluestein.
//
// This is the C++ host-side runtime behind the C ABI (capi.cpp) — the
// native-code component of the framework, mirroring the capability surface of
// the reference's fourier-algorithms crate (see SURVEY.md §2.1): arbitrary-size
// complex-to-complex FFTs (Stockham autosort with the RADICES=[4,8,4,3,2]
// schedule for 2^a*3^b sizes, Bluestein chirp-z otherwise), five normalization
// modes, plan-then-execute with all trigonometry at plan time in double
// precision. Freshly written C++17; the card's compute path lives in CUDA —
// this core serves host callers (C/C++ consumers, harness tests, CPU fallback).
#pragma once

#include <complex>
#include <cstddef>
#include <memory>
#include <ostream>
#include <vector>

namespace fourier_tpu {

enum class Transform : int {
  kFft = 0,
  kIfft = 1,
  kUnscaledIfft = 2,
  kSqrtScaledFft = 3,
  kSqrtScaledIfft = 4,
};

inline bool is_forward(Transform t) {
  return t == Transform::kFft || t == Transform::kSqrtScaledFft;
}

// Abstract plan: the C++ analog of the Python FftPlan (fourier_tpu_torch/plan/base.py) and the
// reference's Fft trait semantics.
template <typename T>
class FftPlan {
 public:
  virtual ~FftPlan() = default;
  virtual std::size_t size() const = 0;
  // In-place transform of `size()` interleaved complex values. Plans own a
  // scratch buffer; a single plan must not be used concurrently from multiple
  // threads (matches the reference's Send-not-Sync contract).
  virtual void transform_in_place(std::complex<T>* data, Transform t) = 0;

  // Introspection: write the plan's static structure (kind, schedule) and
  // every precomputed table as machine-readable text. Exists so the Python
  // planner and this native planner can be diffed against each other — the
  // two implementations share semantics by contract, and the plan-parity
  // test (tools/dump_plan.cpp + plan_parity.py) turns that
  // contract into a ctest gate.
  virtual void dump(std::ostream& os) const = 0;

  void transform(const std::complex<T>* in, std::complex<T>* out, Transform t) {
    for (std::size_t i = 0; i < size(); ++i) out[i] = in[i];
    transform_in_place(out, t);
  }
};

// Factory: Stockham autosort when the size factors over {4,8,4,3,2}, else
// Bluestein. Returns nullptr only for size == 0.
template <typename T>
std::unique_ptr<FftPlan<T>> create_plan(std::size_t size);

extern template std::unique_ptr<FftPlan<float>> create_plan<float>(std::size_t);
extern template std::unique_ptr<FftPlan<double>> create_plan<double>(std::size_t);

}  // namespace fourier_tpu
