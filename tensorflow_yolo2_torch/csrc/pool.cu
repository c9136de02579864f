// Backward pass of the 2x2 stride-2 max pool, written for Hopper (sm_90a).
//
// Replaces tensorflow_yolo2_tpu/ops/pallas_pool.py: _pool_bwd_pallas /
// _pool_bwd_kernel (the VJP of max_pool2).
//
// Inputs are NHWC in storage (the trunk's NCHW activations in channels_last
// memory): x (N, H, W, C) with H and W even, y = maxpool(x) (N, H/2, W/2, C)
// and dout of y's shape, all of one type, float32 or bfloat16. The output dx
// has x's shape. In each 2x2 window dout goes to the FIRST element equal to
// y in the order (0,0), (0,1), (1,0), (1,1) -- the tie rule of XLA's
// SelectAndScatter and of PyTorch's max_pool2d backward -- and every other
// element gets +0. The comparison runs in float32, to which bfloat16
// converts exactly; dout is copied bit for bit.
//
// One thread per output element (n, h/2, w/2, c), with c fastest, so that a
// warp's loads of y and dout and of each window position of x are
// contiguous. The pass is bound by bytes: it reads x, y and dout and writes
// dx once, 2.5 |x| bytes, and does 4 compares a window.
//
// tfy2_pool2_bwd returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);  // bf16 -> f32, exact
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ dout, T* __restrict__ dx, int64_t total,
                 int H2, int W2, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  int64_t rest = i / C;
  const int w2 = static_cast<int>(rest % W2);
  rest /= W2;
  const int h2 = static_cast<int>(rest % H2);
  const int64_t n = rest / H2;

  const int64_t row = static_cast<int64_t>(2 * W2) * C;  // one input row
  const int64_t x00 = ((n * 2 * H2 + 2 * h2) * (2 * W2) + 2 * w2) * C + c;
  const int64_t pos[4] = {x00, x00 + C, x00 + row, x00 + row + C};

  const float m = to_float(y[i]);
  const T d = dout[i];
  const T zero = T(0);  // +0 in both types
  bool taken = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hit = !taken && to_float(x[pos[k]]) == m;
    dx[pos[k]] = hit ? d : zero;
    taken = taken || hit;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* dout, void* dx,
                   int64_t total, int H2, int W2, int C, cudaStream_t stream) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  pool2_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dout), static_cast<T*>(dx), total, H2, W2, C);
  return cudaGetLastError();
}

}  // namespace

// x, dx: (N, H, W, C); y, dout: (N, H/2, W/2, C); contiguous, on the device.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" cudaError_t tfy2_pool2_bwd(const void* x, const void* y, const void* dout,
                                      void* dx, int N, int H, int W, int C, int dtype,
                                      cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2)
    return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(N) * (H / 2) * (W / 2) * C;
  if ((total + kThreads - 1) / kThreads > 0x7fffffff) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, y, dout, dx, total, H / 2, W / 2, C, stream);
  if (dtype == 1) return launch<uint16_t>(x, y, dout, dx, total, H / 2, W / 2, C, stream);
  return cudaErrorInvalidValue;
}
