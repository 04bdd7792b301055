// Plan introspection CLI: print a native plan's schedule + tables as text.
//
// Usage: dump_plan <size> <f32|f64>
//
// The output feeds plan_parity.py, which rebuilds the same plan with the
// Python planner (fourier_tpu_torch.plan) and fails if the two planners
// ever disagree on schedule or tables — the native core and the Python path
// share semantics by contract (both mirror autosort/mod.rs:104-134 +
// bluesteins.rs:18-61 of the reference), and this turns the contract into a
// CI gate.

#include <cstdlib>
#include <iostream>
#include <string>

#include "../src/fft_core.hpp"

int main(int argc, char** argv) {
  if (argc != 3) {
    std::cerr << "usage: dump_plan <size> <f32|f64>\n";
    return 2;
  }
  const unsigned long long size = std::strtoull(argv[1], nullptr, 10);
  const std::string dtype = argv[2];
  if (size == 0) {
    std::cerr << "size must be positive\n";
    return 2;
  }
  if (dtype == "f32") {
    auto plan = fourier_tpu::create_plan<float>(size);
    plan->dump(std::cout);
  } else if (dtype == "f64") {
    auto plan = fourier_tpu::create_plan<double>(size);
    plan->dump(std::cout);
  } else {
    std::cerr << "dtype must be f32 or f64\n";
    return 2;
  }
  return 0;
}
