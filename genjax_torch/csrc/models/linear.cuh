// The linear-Gaussian model of the fused filter's Kalman check in the
// form the fused filter step (csrc/fused_step.cu) compiles in; its torch
// form is genjax_torch/entry.py::linear_propagate / linear_loglik, and the
// constants come from entry.py::LINEAR_CUDA in this order:
//   p[0] = LINEAR_A, p[1] = sqrt(LINEAR_Q), p[2] = LINEAR_R,
//   p[3] = LINEAR_HALF_LOG_2PI_R.

#pragma once

namespace fused_model {

constexpr int kParams = 4;

// a x + sqrt(q) eps
__device__ __forceinline__ float propagate(float x, float eps,
                                           const float* p) {
  return p[0] * x + p[1] * eps;
}

// log N(y; x, r)
__device__ __forceinline__ float loglik(float x, float y, const float* p) {
  const float d = y - x;
  return -0.5f * (d * d) / p[2] - p[3];
}

}  // namespace fused_model
