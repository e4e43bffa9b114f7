// Diagonal-covariance GMM (EM) and Fisher-vector encoding (clean-room).
//
// Parity targets: utils.external.EncEval.{computeGMM, calcAndGetFVs}
// (SURVEY.md §2.3) [unverified]. The math follows the standard
// Perronnin-style improved-Fisher-vector formulation; the normalization
// (signed sqrt, L2) is intentionally left to pipeline nodes, mirroring the
// reference where SignedHellingerMapper is a separate stage.

#include "keystone_native.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float kMinVar = 1e-4f;
constexpr float kTwoPi = 6.28318530717958647692f;

// log sum exp over k contiguous floats.
float logsumexp(const float* v, int k) {
  float m = v[0];
  for (int i = 1; i < k; ++i) m = std::max(m, v[i]);
  float s = 0.0f;
  for (int i = 0; i < k; ++i) s += std::exp(v[i] - m);
  return m + std::log(s);
}

// Per-sample responsibilities into r (n, k); returns total log-likelihood.
double e_step(const float* X, int n, int d, const float* w, const float* mu,
              const float* var, int k, float* r) {
  // Precompute per-component log normalizers.
  std::vector<float> log_norm(k);
  for (int j = 0; j < k; ++j) {
    float ld = 0.0f;
    for (int t = 0; t < d; ++t) ld += std::log(var[j * d + t]);
    log_norm[j] = std::log(std::max(w[j], 1e-12f)) -
                  0.5f * (d * std::log(kTwoPi) + ld);
  }
  double total = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : total) schedule(static)
#endif
  for (int i = 0; i < n; ++i) {
    const float* x = X + static_cast<std::size_t>(i) * d;
    float* ri = r + static_cast<std::size_t>(i) * k;
    for (int j = 0; j < k; ++j) {
      const float* m = mu + static_cast<std::size_t>(j) * d;
      const float* v = var + static_cast<std::size_t>(j) * d;
      float q = 0.0f;
      for (int t = 0; t < d; ++t) {
        const float diff = x[t] - m[t];
        q += diff * diff / v[t];
      }
      ri[j] = log_norm[j] - 0.5f * q;
    }
    const float lse = logsumexp(ri, k);
    total += lse;
    for (int j = 0; j < k; ++j) ri[j] = std::exp(ri[j] - lse);
  }
  return total;
}

}  // namespace

extern "C" {

int ks_gmm_fit(const float* X, int n, int d, int k, int iters,
               std::uint64_t seed, float* weights, float* means, float* vars) {
  if (!X || !weights || !means || !vars || n < k || d <= 0 || k <= 0 ||
      iters < 0)
    return -1;

  // ---- init: distance-weighted (k-means++-style) seeding ----
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int> uni(0, n - 1);
  std::vector<float> d2(n, std::numeric_limits<float>::max());
  int first = uni(rng);
  std::memcpy(means, X + static_cast<std::size_t>(first) * d,
              d * sizeof(float));
  for (int j = 1; j < k; ++j) {
    double sum = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : sum) schedule(static)
#endif
    for (int i = 0; i < n; ++i) {
      const float* x = X + static_cast<std::size_t>(i) * d;
      const float* m = means + static_cast<std::size_t>(j - 1) * d;
      float dist = 0.0f;
      for (int t = 0; t < d; ++t) {
        const float diff = x[t] - m[t];
        dist += diff * diff;
      }
      d2[i] = std::min(d2[i], dist);
      sum += d2[i];
    }
    std::uniform_real_distribution<double> u(0.0, sum);
    double target = u(rng), acc = 0.0;
    int pick = n - 1;
    for (int i = 0; i < n; ++i) {
      acc += d2[i];
      if (acc >= target) {
        pick = i;
        break;
      }
    }
    std::memcpy(means + static_cast<std::size_t>(j) * d,
                X + static_cast<std::size_t>(pick) * d, d * sizeof(float));
  }
  // Global variance as the initial spread; uniform weights.
  std::vector<double> gmean(d, 0.0), gvar(d, 0.0);
  for (int i = 0; i < n; ++i)
    for (int t = 0; t < d; ++t) gmean[t] += X[static_cast<std::size_t>(i) * d + t];
  for (int t = 0; t < d; ++t) gmean[t] /= n;
  for (int i = 0; i < n; ++i)
    for (int t = 0; t < d; ++t) {
      const double diff = X[static_cast<std::size_t>(i) * d + t] - gmean[t];
      gvar[t] += diff * diff;
    }
  for (int j = 0; j < k; ++j) {
    weights[j] = 1.0f / k;
    for (int t = 0; t < d; ++t)
      vars[static_cast<std::size_t>(j) * d + t] =
          std::max(static_cast<float>(gvar[t] / n), kMinVar);
  }

  // ---- EM ----
  std::vector<float> r(static_cast<std::size_t>(n) * k);
  for (int it = 0; it < iters; ++it) {
    e_step(X, n, d, weights, means, vars, k, r.data());
    // M-step: accumulate per-component moments.
    std::vector<double> nk(k, 0.0);
    std::vector<double> sum1(static_cast<std::size_t>(k) * d, 0.0);
    std::vector<double> sum2(static_cast<std::size_t>(k) * d, 0.0);
#ifdef _OPENMP
#pragma omp parallel
    {
      std::vector<double> lnk(k, 0.0);
      std::vector<double> ls1(static_cast<std::size_t>(k) * d, 0.0);
      std::vector<double> ls2(static_cast<std::size_t>(k) * d, 0.0);
#pragma omp for schedule(static) nowait
      for (int i = 0; i < n; ++i) {
        const float* x = X + static_cast<std::size_t>(i) * d;
        const float* ri = r.data() + static_cast<std::size_t>(i) * k;
        for (int j = 0; j < k; ++j) {
          const double g = ri[j];
          if (g < 1e-10) continue;
          lnk[j] += g;
          double* s1 = ls1.data() + static_cast<std::size_t>(j) * d;
          double* s2 = ls2.data() + static_cast<std::size_t>(j) * d;
          for (int t = 0; t < d; ++t) {
            const double gx = g * x[t];
            s1[t] += gx;
            s2[t] += gx * x[t];
          }
        }
      }
#pragma omp critical
      {
        for (int j = 0; j < k; ++j) nk[j] += lnk[j];
        for (std::size_t idx = 0; idx < sum1.size(); ++idx) {
          sum1[idx] += ls1[idx];
          sum2[idx] += ls2[idx];
        }
      }
    }
#else
    for (int i = 0; i < n; ++i) {
      const float* x = X + static_cast<std::size_t>(i) * d;
      const float* ri = r.data() + static_cast<std::size_t>(i) * k;
      for (int j = 0; j < k; ++j) {
        const double g = ri[j];
        if (g < 1e-10) continue;
        nk[j] += g;
        double* s1 = sum1.data() + static_cast<std::size_t>(j) * d;
        double* s2 = sum2.data() + static_cast<std::size_t>(j) * d;
        for (int t = 0; t < d; ++t) {
          const double gx = g * x[t];
          s1[t] += gx;
          s2[t] += gx * x[t];
        }
      }
    }
#endif
    for (int j = 0; j < k; ++j) {
      const double denom = std::max(nk[j], 1e-10);
      weights[j] = static_cast<float>(nk[j] / n);
      float* m = means + static_cast<std::size_t>(j) * d;
      float* v = vars + static_cast<std::size_t>(j) * d;
      const double* s1 = sum1.data() + static_cast<std::size_t>(j) * d;
      const double* s2 = sum2.data() + static_cast<std::size_t>(j) * d;
      for (int t = 0; t < d; ++t) {
        const double mean = s1[t] / denom;
        m[t] = static_cast<float>(mean);
        v[t] = std::max(
            static_cast<float>(s2[t] / denom - mean * mean), kMinVar);
      }
    }
  }
  return 0;
}

int ks_fisher_vector(const float* X, int n, int d, const float* weights,
                     const float* means, const float* vars, int k,
                     float* out) {
  if (!X || !weights || !means || !vars || !out || n <= 0 || d <= 0 || k <= 0)
    return -1;
  std::vector<float> r(static_cast<std::size_t>(n) * k);
  e_step(X, n, d, weights, means, vars, k, r.data());
  std::memset(out, 0, static_cast<std::size_t>(2) * k * d * sizeof(float));
  float* gmu = out;            // (k, d)
  float* gvar = out + static_cast<std::size_t>(k) * d;  // (k, d)
  for (int i = 0; i < n; ++i) {
    const float* x = X + static_cast<std::size_t>(i) * d;
    const float* ri = r.data() + static_cast<std::size_t>(i) * k;
    for (int j = 0; j < k; ++j) {
      const float g = ri[j];
      if (g < 1e-10f) continue;
      const float* m = means + static_cast<std::size_t>(j) * d;
      const float* v = vars + static_cast<std::size_t>(j) * d;
      float* gm = gmu + static_cast<std::size_t>(j) * d;
      float* gv = gvar + static_cast<std::size_t>(j) * d;
      for (int t = 0; t < d; ++t) {
        const float u = (x[t] - m[t]) / std::sqrt(v[t]);
        gm[t] += g * u;
        gv[t] += g * (u * u - 1.0f);
      }
    }
  }
  for (int j = 0; j < k; ++j) {
    const float sw = std::sqrt(std::max(weights[j], 1e-12f));
    const float cm = 1.0f / (n * sw);
    const float cv = 1.0f / (n * sw * std::sqrt(2.0f));
    float* gm = gmu + static_cast<std::size_t>(j) * d;
    float* gv = gvar + static_cast<std::size_t>(j) * d;
    for (int t = 0; t < d; ++t) {
      gm[t] *= cm;
      gv[t] *= cv;
    }
  }
  return 0;
}

}  // extern "C"
