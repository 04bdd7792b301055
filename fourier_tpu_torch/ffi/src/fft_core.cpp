// Implementation of the fourier-tpu native host core. See fft_core.hpp.
//
// Semantics tracked against the reference (citations per SURVEY.md):
//   * radix schedule: one leading 4, then greedy 8s/4s/3s/2s
//     (autosort/mod.rs:104-134)
//   * per-stage twiddle layout W_size^(i*k) (autosort/mod.rs:24-46)
//   * stage indexing: input (r, m, stride) -> butterfly -> twiddle ->
//     output (m, r, stride) (autosort/mod.rs:174-310)
//   * normalization: none | 1/N | 1/sqrt(N) applied once at the end
//     (autosort/mod.rs:381-394)
//   * Bluestein: inner = next_pow2(2n-1), plan-time chirp FFT, x/w tables
//     (bluesteins.rs:18-61,109-130,215-259)
// The code itself is an independent C++ design (planar scratch-free stage
// loop over interleaved std::complex, ping-pong buffers, recursive plan
// ownership) — not a translation.

#include "fft_core.hpp"

#include <cmath>
#include <cstdint>
#include <limits>

namespace fourier_tpu {
namespace {

constexpr double kPi = 3.141592653589793238462643383279502884;

// exp(-2*pi*i*index/size), conjugated for inverse — always computed in double
// and narrowed (twiddle.rs:9-13 semantics).
template <typename T>
std::complex<T> unit_twiddle(double index, double size, bool forward) {
  const double theta = 2.0 * kPi * index / size;
  const double re = std::cos(theta);
  const double im = -std::sin(theta);
  return std::complex<T>(static_cast<T>(re), static_cast<T>(forward ? im : -im));
}

// ---------------------------------------------------------------------------
// Stockham autosort
// ---------------------------------------------------------------------------

struct Factorization {
  std::vector<std::size_t> radices;  // expanded stage order
  bool ok = false;
};

// Full-precision text table dump (round-trips exactly through parsing).
template <typename T>
void dump_table(std::ostream& os, const char* name,
                const std::vector<std::complex<T>>& v) {
  os.precision(std::numeric_limits<T>::max_digits10);
  os << "table " << name << ' ' << v.size() << '\n';
  for (const auto& z : v) os << z.real() << ' ' << z.imag() << '\n';
}

Factorization factorize(std::size_t n) {
  static constexpr std::size_t kSchedule[] = {4, 8, 4, 3, 2};
  Factorization f;
  std::size_t rem = n;
  // one leading radix-4 stage, then greedy
  if (rem % 4 == 0) {
    f.radices.push_back(4);
    rem /= 4;
  }
  for (std::size_t idx = 1; idx < 5; ++idx) {
    const std::size_t r = kSchedule[idx];
    while (rem % r == 0) {
      f.radices.push_back(r);
      rem /= r;
    }
  }
  f.ok = (rem == 1);
  return f;
}

template <typename T>
class StockhamPlan final : public FftPlan<T> {
 public:
  StockhamPlan(std::size_t n, std::vector<std::size_t> radices)
      : n_(n), radices_(std::move(radices)), work_(n) {
    // Per-stage twiddle tables, entry (i, k) = W_size^(i*k), both directions.
    std::size_t size = n;
    for (std::size_t r : radices_) {
      const std::size_t m = size / r;
      for (std::size_t i = 0; i < m; ++i) {
        for (std::size_t k = 0; k < r; ++k) {
          fwd_tw_.push_back(unit_twiddle<T>(double(i) * double(k), double(size), true));
          inv_tw_.push_back(unit_twiddle<T>(double(i) * double(k), double(size), false));
        }
      }
      size = m;
    }
  }

  std::size_t size() const override { return n_; }

  void dump(std::ostream& os) const override {
    os << "plan stockham\nsize " << n_ << "\nradices";
    for (std::size_t r : radices_) os << ' ' << r;
    os << '\n';
    dump_table(os, "fwd_tw", fwd_tw_);
    dump_table(os, "inv_tw", inv_tw_);
    os << "end\n";
  }

  void transform_in_place(std::complex<T>* data, Transform t) override {
    const bool forward = is_forward(t);
    const std::complex<T>* tw = forward ? fwd_tw_.data() : inv_tw_.data();
    std::complex<T>* a = data;
    std::complex<T>* b = work_.data();
    std::size_t size = n_;
    std::size_t stride = 1;
    bool in_work = false;
    for (std::size_t r : radices_) {
      const std::size_t m = size / r;
      apply_stage(a, b, r, m, stride, tw, forward, size == r);
      tw += m * r;
      std::swap(a, b);
      in_work = !in_work;
      size = m;
      stride *= r;
    }
    finish(data, a, in_work, t);
  }

 private:
  // One Stockham stage: in viewed (r, m, stride), out viewed (m, r, stride).
  static void apply_stage(const std::complex<T>* in, std::complex<T>* out,
                          std::size_t r, std::size_t m, std::size_t stride,
                          const std::complex<T>* tw, bool forward, bool last) {
    std::complex<T> v[8], w[8];
    for (std::size_t i = 0; i < m; ++i) {
      const std::complex<T>* trow = tw + i * r;
      for (std::size_t j = 0; j < stride; ++j) {
        for (std::size_t k = 0; k < r; ++k) v[k] = in[stride * (k * m + i) + j];
        butterfly(v, w, r, forward);
        if (!last) {
          for (std::size_t k = 1; k < r; ++k) w[k] *= trow[k];
        }
        for (std::size_t k = 0; k < r; ++k) out[stride * (r * i + k) + j] = w[k];
      }
    }
  }

  static std::complex<T> rot(std::complex<T> z, bool positive) {
    // multiply by +i (positive) / -i
    return positive ? std::complex<T>(-z.imag(), z.real())
                    : std::complex<T>(z.imag(), -z.real());
  }

  static void butterfly(const std::complex<T>* x, std::complex<T>* y,
                        std::size_t r, bool forward) {
    switch (r) {
      case 2: {
        y[0] = x[0] + x[1];
        y[1] = x[0] - x[1];
        break;
      }
      case 3: {
        const T half = T(0.5);
        const T s60 = T(0.86602540378443864676);
        const std::complex<T> sum = x[1] + x[2];
        const std::complex<T> dif = x[1] - x[2];
        const std::complex<T> base = x[0] - half * sum;
        const std::complex<T> j_dif = forward
            ? std::complex<T>(s60 * dif.imag(), -s60 * dif.real())
            : std::complex<T>(-s60 * dif.imag(), s60 * dif.real());
        y[0] = x[0] + sum;
        y[1] = base + j_dif;
        y[2] = base - j_dif;
        break;
      }
      case 4: {
        const std::complex<T> a0 = x[0] + x[2];
        const std::complex<T> a1 = x[0] - x[2];
        const std::complex<T> a2 = x[1] + x[3];
        const std::complex<T> a3 = rot(x[1] - x[3], forward);
        y[0] = a0 + a2;
        y[1] = a1 - a3;
        y[2] = a0 - a2;
        y[3] = a1 + a3;
        break;
      }
      case 8: {
        const T c = T(0.70710678118654752440);
        std::complex<T> e[4], o[4];
        {
          const std::complex<T> xe[4] = {x[0], x[2], x[4], x[6]};
          butterfly(xe, e, 4, forward);
          const std::complex<T> xo[4] = {x[1], x[3], x[5], x[7]};
          butterfly(xo, o, 4, forward);
        }
        // W_8^1 = c -/+ ci ; W_8^2 = -/+i ; W_8^3 = -c -/+ ci
        const T ti = forward ? -c : c;
        o[1] = std::complex<T>(o[1].real() * c - o[1].imag() * ti,
                               o[1].real() * ti + o[1].imag() * c);
        o[2] = rot(o[2], !forward);
        o[3] = std::complex<T>(o[3].real() * -c - o[3].imag() * ti,
                               o[3].real() * ti - o[3].imag() * c);
        for (int k = 0; k < 4; ++k) {
          y[k] = e[k] + o[k];
          y[k + 4] = e[k] - o[k];
        }
        break;
      }
      default:
        break;  // unreachable: schedule only emits 2/3/4/8
    }
  }

  void finish(std::complex<T>* data, std::complex<T>* result, bool in_work,
              Transform t) {
    T scale = T(1);
    bool do_scale = false;
    if (t == Transform::kIfft) {
      scale = T(1) / T(n_);
      do_scale = true;
    } else if (t == Transform::kSqrtScaledFft || t == Transform::kSqrtScaledIfft) {
      scale = T(1) / static_cast<T>(std::sqrt(double(n_)));
      do_scale = true;
    }
    if (in_work) {
      for (std::size_t i = 0; i < n_; ++i)
        data[i] = do_scale ? result[i] * scale : result[i];
    } else if (do_scale) {
      for (std::size_t i = 0; i < n_; ++i) data[i] *= scale;
    }
  }

  std::size_t n_;
  std::vector<std::size_t> radices_;
  std::vector<std::complex<T>> fwd_tw_, inv_tw_, work_;
};

// ---------------------------------------------------------------------------
// Bluestein chirp-z
// ---------------------------------------------------------------------------

std::size_t next_pow2(std::size_t n) {
  std::size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
class BluesteinPlan final : public FftPlan<T> {
 public:
  explicit BluesteinPlan(std::size_t n)
      : n_(n), m_(next_pow2(2 * n - 1)), work_(m_) {
    auto fac = factorize(m_);
    inner_ = std::make_unique<StockhamPlan<T>>(m_, std::move(fac.radices));
    // x (conjugate chirp) tables, exp(-/+ i*pi*j^2/n)  (bluesteins.rs:51-61)
    x_fwd_.resize(n_);
    x_inv_.resize(n_);
    for (std::size_t j = 0; j < n_; ++j) {
      const double theta = kPi * double(j) * double(j) / double(n_);
      x_fwd_[j] = std::complex<T>(T(std::cos(theta)), T(-std::sin(theta)));
      x_inv_[j] = std::conj(x_fwd_[j]);
    }
    // w tables: forward FFT of the wrap-mirrored (conj-)chirp
    // (bluesteins.rs:18-48; the plan-time inner FFT happens right here).
    w_fwd_.assign(m_, std::complex<T>(0, 0));
    w_inv_.assign(m_, std::complex<T>(0, 0));
    for (std::size_t i = 0; i < m_; ++i) {
      double d;
      if (i < n_) {
        d = double(i) * double(i);
      } else if (i > m_ - n_) {
        const double s = double(i) - double(m_);
        d = s * s;
      } else {
        continue;
      }
      const double theta = kPi * d / double(n_);
      const std::complex<T> chirp(T(std::cos(theta)), T(-std::sin(theta)));
      w_fwd_[i] = std::conj(chirp);
      w_inv_[i] = chirp;
    }
    inner_->transform_in_place(w_fwd_.data(), Transform::kFft);
    inner_->transform_in_place(w_inv_.data(), Transform::kFft);
  }

  std::size_t size() const override { return n_; }

  void dump(std::ostream& os) const override {
    os << "plan bluestein\nsize " << n_ << "\ninner_size " << m_ << '\n';
    dump_table(os, "x_fwd", x_fwd_);
    dump_table(os, "x_inv", x_inv_);
    dump_table(os, "w_fwd", w_fwd_);
    dump_table(os, "w_inv", w_inv_);
    os << "inner\n";
    inner_->dump(os);
    os << "end\n";
  }

  void transform_in_place(std::complex<T>* data, Transform t) override {
    const bool forward = is_forward(t);
    const auto& x = forward ? x_fwd_ : x_inv_;
    const auto& w = forward ? w_fwd_ : w_inv_;
    for (std::size_t i = 0; i < n_; ++i) work_[i] = x[i] * data[i];
    for (std::size_t i = n_; i < m_; ++i) work_[i] = std::complex<T>(0, 0);
    inner_->transform_in_place(work_.data(), Transform::kFft);
    for (std::size_t i = 0; i < m_; ++i) work_[i] *= w[i];
    inner_->transform_in_place(work_.data(), Transform::kIfft);  // absorbs 1/M
    T scale = T(1);
    if (t == Transform::kIfft) {
      scale = T(1) / T(n_);
    } else if (t == Transform::kSqrtScaledFft || t == Transform::kSqrtScaledIfft) {
      scale = T(1) / static_cast<T>(std::sqrt(double(n_)));
    }
    for (std::size_t i = 0; i < n_; ++i) data[i] = work_[i] * x[i] * scale;
  }

 private:
  std::size_t n_, m_;
  std::unique_ptr<StockhamPlan<T>> inner_;
  std::vector<std::complex<T>> x_fwd_, x_inv_, w_fwd_, w_inv_, work_;
};

}  // namespace

template <typename T>
std::unique_ptr<FftPlan<T>> create_plan(std::size_t size) {
  if (size == 0) return nullptr;
  auto fac = factorize(size);
  if (fac.ok) {
    return std::make_unique<StockhamPlan<T>>(size, std::move(fac.radices));
  }
  return std::make_unique<BluesteinPlan<T>>(size);
}

template std::unique_ptr<FftPlan<float>> create_plan<float>(std::size_t);
template std::unique_ptr<FftPlan<double>> create_plan<double>(std::size_t);

}  // namespace fourier_tpu
