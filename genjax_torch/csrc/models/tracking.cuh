// The nonlinear 1-D tracking model of bench config 4 in the form the
// fused filter step (csrc/fused_step.cu) compiles in; its torch form is
// genjax_torch/entry.py::tracking_propagate / tracking_loglik, and the
// constants come from entry.py::TRACKING_CUDA in this order:
//   p[0] = TRACKING_SD, the process-noise sd (sqrt 10);
//   p[1] = HALF_LOG_2PI, the log-normalizer of the unit-variance likelihood.
// The operations follow the torch form's order; the two divisions are the
// card's fast ones (__fdividef, within 2 ulp, and x^2 times 1/20), as the
// precise division's range check costs 0.6 us a step at 2^20 particles.

#pragma once

namespace fused_model {

constexpr int kParams = 2;

// 0.5 x + 25 x / (1 + x^2) + sd eps
__device__ __forceinline__ float propagate(float x, float eps,
                                           const float* p) {
  return 0.5f * x + __fdividef(25.0f * x, 1.0f + x * x) + p[0] * eps;
}

// log N(y; x^2 / 20, 1)
__device__ __forceinline__ float loglik(float x, float y, const float* p) {
  const float d = y - x * x * 0.05f;
  return -0.5f * (d * d) - p[1];
}

}  // namespace fused_model
