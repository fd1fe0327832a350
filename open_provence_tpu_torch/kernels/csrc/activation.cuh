// The MLP activations of ln_gemm.cu and their derivatives for
// ln_gemm_bwd.cu, in fp32, keyed by the codes the Python wrappers pass
// (ops/geglu.py::ACTIVATIONS). The exact gelu uses erff; the TPU kernels
// use Eigen's erf polynomial because Mosaic has no erf.
#pragma once

#include <math.h>

enum { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float activation(float x, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case ACT_GELU_TANH: {
      const float inner = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
      return 0.5f * x * (1.f + tanhf(inner));
    }
    case ACT_RELU:
      return fmaxf(x, 0.f);
    default:  // ACT_SILU
      return x / (1.f + expf(-x));
  }
}

// d activation / dx, as ops/geglu.py::_KERNEL_ACTIVATION_GRADS writes it.
__device__ __forceinline__ float activation_grad(float x, int act) {
  switch (act) {
    case ACT_GELU: {
      const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
      return cdf + x * 0.39894228040143268f * expf(-0.5f * x * x);
    }
    case ACT_GELU_TANH: {
      const float u = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
      const float t = tanhf(u);
      const float du = 0.79788456080286536f * (1.f + 3.f * 0.044715f * (x * x));
      return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
    }
    case ACT_RELU:
      return x > 0.f ? 1.f : 0.f;
    default: {  // ACT_SILU
      const float s = 1.f / (1.f + expf(-x));
      return s * (1.f + x * (1.f - s));
    }
  }
}
