#include "gaussian_process.h"

#include <algorithm>
#include <cmath>

namespace hvdtpu {

namespace {

// Dense Cholesky decomposition A = L L^T; returns false if not SPD.
bool Cholesky(std::vector<double>& a, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double sum = a[i * n + j];
      for (int k = 0; k < j; ++k) sum -= a[i * n + k] * a[j * n + k];
      if (i == j) {
        if (sum <= 0.0) return false;
        a[i * n + i] = std::sqrt(sum);
      } else {
        a[i * n + j] = sum / a[j * n + j];
      }
    }
    for (int j = i + 1; j < n; ++j) a[i * n + j] = 0.0;
  }
  return true;
}

// Solve L L^T x = b in place given the Cholesky factor L.
void CholSolve(const std::vector<double>& l, int n, std::vector<double>& b) {
  for (int i = 0; i < n; ++i) {
    double sum = b[i];
    for (int k = 0; k < i; ++k) sum -= l[i * n + k] * b[k];
    b[i] = sum / l[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double sum = b[i];
    for (int k = i + 1; k < n; ++k) sum -= l[k * n + i] * b[k];
    b[i] = sum / l[i * n + i];
  }
}

double NormCdf(double z) { return 0.5 * (1.0 + std::erf(z / std::sqrt(2.0))); }
double NormPdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

}  // namespace

double GaussianProcess::Kernel(const double* a, const double* b,
                               double ls) const {
  double d2 = 0.0;
  for (int k = 0; k < dim_; ++k) {
    double d = a[k] - b[k];
    d2 += d * d;
  }
  return std::exp(-0.5 * d2 / (ls * ls));
}

void GaussianProcess::Fit(const std::vector<double>& x,
                          const std::vector<double>& y, int dim) {
  dim_ = dim;
  n_ = static_cast<int>(y.size());
  x_ = x;
  const double grid[] = {0.1, 0.3, 1.0, 3.0};
  double best_lml = -1e300;
  double best_ls = length_scale_;
  for (double ls : grid) {
    std::vector<double> k(n_ * n_);
    for (int i = 0; i < n_; ++i)
      for (int j = 0; j < n_; ++j)
        k[i * n_ + j] = Kernel(&x_[i * dim_], &x_[j * dim_], ls) +
                        (i == j ? alpha_ : 0.0);
    std::vector<double> l = k;
    if (!Cholesky(l, n_)) continue;
    std::vector<double> a = y;
    CholSolve(l, n_, a);
    double lml = 0.0;
    for (int i = 0; i < n_; ++i) lml -= 0.5 * y[i] * a[i];
    for (int i = 0; i < n_; ++i) lml -= std::log(l[i * n_ + i]);
    if (lml > best_lml) {
      best_lml = lml;
      best_ls = ls;
    }
  }
  length_scale_ = best_ls;

  // Final factorization at the chosen scale; keep K^-1 and K^-1 y.
  std::vector<double> k(n_ * n_);
  for (int i = 0; i < n_; ++i)
    for (int j = 0; j < n_; ++j)
      k[i * n_ + j] = Kernel(&x_[i * dim_], &x_[j * dim_], length_scale_) +
                      (i == j ? alpha_ : 0.0);
  std::vector<double> l = k;
  if (!Cholesky(l, n_)) {
    // Degenerate fit; bump jitter until SPD.
    double jitter = alpha_;
    while (jitter < 1.0) {
      jitter *= 10.0;
      l = k;
      for (int i = 0; i < n_; ++i) l[i * n_ + i] += jitter;
      if (Cholesky(l, n_)) break;
    }
  }
  kinv_y_ = y;
  CholSolve(l, n_, kinv_y_);
  kinv_.assign(n_ * n_, 0.0);
  for (int c = 0; c < n_; ++c) {
    std::vector<double> e(n_, 0.0);
    e[c] = 1.0;
    CholSolve(l, n_, e);
    for (int r = 0; r < n_; ++r) kinv_[r * n_ + c] = e[r];
  }
}

void GaussianProcess::Predict(const std::vector<double>& xq, int m,
                              std::vector<double>* mu,
                              std::vector<double>* sigma) const {
  mu->assign(m, 0.0);
  sigma->assign(m, 1.0);
  if (n_ == 0) return;
  std::vector<double> ks(n_);
  for (int q = 0; q < m; ++q) {
    for (int i = 0; i < n_; ++i)
      ks[i] = Kernel(&xq[q * dim_], &x_[i * dim_], length_scale_);
    double mean = 0.0;
    for (int i = 0; i < n_; ++i) mean += ks[i] * kinv_y_[i];
    (*mu)[q] = mean;
    double var = 1.0;
    for (int i = 0; i < n_; ++i) {
      double t = 0.0;
      for (int j = 0; j < n_; ++j) t += kinv_[i * n_ + j] * ks[j];
      var -= ks[i] * t;
    }
    (*sigma)[q] = std::sqrt(std::max(var, 1e-12));
  }
}

BayesianOptimization::BayesianOptimization(const std::vector<double>& lo,
                                           const std::vector<double>& hi,
                                           double xi, uint64_t seed)
    : dim_(static_cast<int>(lo.size())), lo_(lo), hi_(hi), xi_(xi),
      rng_(seed) {}

void BayesianOptimization::AddSample(const std::vector<double>& x, double y) {
  xs_.insert(xs_.end(), x.begin(), x.end());
  ys_.push_back(y);
}

std::vector<double> BayesianOptimization::Suggest(int n_candidates) {
  std::uniform_real_distribution<double> unit(0.0, 1.0);
  std::vector<double> cand(n_candidates * dim_);
  for (int i = 0; i < n_candidates; ++i)
    for (int k = 0; k < dim_; ++k)
      cand[i * dim_ + k] = lo_[k] + (hi_[k] - lo_[k]) * unit(rng_);

  if (ys_.size() < 2) {
    return std::vector<double>(cand.begin(), cand.begin() + dim_);
  }
  // Fit in the normalized box (matches the Python mirror in autotune.py).
  auto normalize = [&](const std::vector<double>& in, int rows) {
    std::vector<double> out(in.size());
    for (int i = 0; i < rows; ++i)
      for (int k = 0; k < dim_; ++k)
        out[i * dim_ + k] = (in[i * dim_ + k] - lo_[k]) /
                            std::max(hi_[k] - lo_[k], 1e-12);
    return out;
  };
  int n = static_cast<int>(ys_.size());
  gp_.Fit(normalize(xs_, n), ys_, dim_);
  std::vector<double> mu, sigma;
  gp_.Predict(normalize(cand, n_candidates), n_candidates, &mu, &sigma);
  double best = *std::max_element(ys_.begin(), ys_.end());
  int argmax = 0;
  double best_ei = -1e300;
  for (int i = 0; i < n_candidates; ++i) {
    double s = std::max(sigma[i], 1e-12);
    double z = (mu[i] - best - xi_) / s;
    double ei = (mu[i] - best - xi_) * NormCdf(z) + s * NormPdf(z);
    if (ei > best_ei) {
      best_ei = ei;
      argmax = i;
    }
  }
  return std::vector<double>(cand.begin() + argmax * dim_,
                             cand.begin() + (argmax + 1) * dim_);
}

}  // namespace hvdtpu
