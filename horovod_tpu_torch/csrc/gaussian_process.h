// Gaussian-process regression + expected-improvement Bayesian optimization
// (native core).
//
// Reference equivalent: horovod/common/optim/gaussian_process.{h,cc} and
// bayesian_optimization.{h,cc} (Eigen + vendored L-BFGS). The tuning domain
// is tiny (2-D: fusion threshold x cycle time), so this implementation
// carries its own dense Cholesky (no Eigen dependency) and replaces the
// L-BFGS kernel-hyperparameter fit with a marginal-likelihood grid over
// length scales — same role, adequate at this scale.
#pragma once

#include <cstdint>
#include <random>
#include <vector>

namespace hvdtpu {

class GaussianProcess {
 public:
  explicit GaussianProcess(double alpha = 1e-6) : alpha_(alpha) {}

  // x: n rows of dim features (row-major). Fits the RBF length scale by
  // log-marginal-likelihood over a fixed grid.
  void Fit(const std::vector<double>& x, const std::vector<double>& y,
           int dim);
  // Posterior mean/stddev at m query rows.
  void Predict(const std::vector<double>& xq, int m, std::vector<double>* mu,
               std::vector<double>* sigma) const;
  double length_scale() const { return length_scale_; }

 private:
  double Kernel(const double* a, const double* b, double ls) const;

  double alpha_;
  double length_scale_ = 1.0;
  int dim_ = 0;
  int n_ = 0;
  std::vector<double> x_;
  std::vector<double> kinv_y_;   // K^-1 y
  std::vector<double> kinv_;     // K^-1 (row-major n x n)
};

class BayesianOptimization {
 public:
  // bounds: dim pairs (lo, hi); xi: EI exploration margin
  // (reference: bayesian_optimization.h:45).
  BayesianOptimization(const std::vector<double>& lo,
                       const std::vector<double>& hi, double xi,
                       uint64_t seed);

  void AddSample(const std::vector<double>& x, double y);
  // Next point maximizing expected improvement over random candidates.
  std::vector<double> Suggest(int n_candidates = 256);

 private:
  int dim_;
  std::vector<double> lo_, hi_;
  double xi_;
  std::mt19937_64 rng_;
  GaussianProcess gp_;
  std::vector<double> xs_;  // flattened samples
  std::vector<double> ys_;
};

}  // namespace hvdtpu
