// Fused Darknet19 stem in float32, written for Hopper (sm_90a): conv1 3x3
// 3->32 + bias + leaky + 2x2 max pool, then conv2 3x3 32->64 + bias + leaky
// + 2x2 max pool, SAME padding, BN folded into the kernels and biases. The
// float32 sibling of stem.cu (B4, bf16 on the tensor cores).
//
// Replaces tensorflow_yolo2_tpu/ops/pallas_stem.py: fused_stem / _stem_kernel
// with dtype=float32.
//
// Input x (N, H, W, 3) float32, H and W multiples of 4. Output
// (N, H/4, W/4, 64) float32. The weights are the HWIO kernels as they are
// (ops/cuda_stem.py::pack_stem_weights keeps them contiguous), read as
// (K, O) matrices, K = 9*C, k = (dy*3 + dx)*C + c: w1 (27, 32), w2
// (288, 64); biases (32,) and (64,). All float32.
//
// Numerics, as _stem_kernel's in float32: float32 products and sums on the
// FMA units (no TF32: it keeps 10 bits of mantissa and would miss the
// 1e-5 the plain version is held to); bias and leaky max(0.1 x, x) in
// float32 with no FMA contraction; the stage-1 map kept in float32. The
// pool is taken before the bias and the leaky, as the plain version takes
// it: both are monotone. Only the order of the sums differs from the plain
// version.
//
// Work split, B4's geometry. A block walks over tiles (a persistent grid,
// one block an SM); a tile is one image's 8 x 16 stage-2 output pixels.
// Per tile the block loads the 38 x 70 x 3 input patch into shared memory
// (zeros outside the image), computes the stage-1 map p1 over the tile
// plus a one-pixel halo, 18 x 34 x 32 (a halo pixel outside the image is
// 0, conv2's SAME padding, not leaky(b1)), then conv2 over p1 with the
// pool, bias and leaky in registers, writing NHWC float32. Both kernels
// and biases stay in shared memory for the life of the block.
//
// conv1: a thread takes one p1 pixel (its 2x2 pre-pool quad) for 8 of the
// 32 channels; it holds the quad's 4 x 4 x 3 input window in registers and
// reads the weights as float4 broadcasts (a warp's threads share their
// channels). conv2: a thread takes one output pixel's quad for 16 of the 64
// channels (64 accumulators), walking the 9 taps x 32 channels with float4
// loads of p1 and float4 broadcasts of w2: 256 FFMA for every 20 shared
// loads. p1 keeps even and odd columns apart (column j at (j % 2) * 17 +
// j / 2) with a 36-float pixel stride, so the 8 threads of a quarter warp,
// two columns apart in p1, read 8 distinct 16-byte bank groups.
//
// Bound: at batch 256, 448^2 the work is 562 GFLOP (conv1 0.347 + conv2
// 1.850 GFLOP an image): 8.39 ms at 67 TFLOP/s of float32 FMA; the least
// time at float32 accuracy on the tensor cores (3xTF32, three passes at
// 494.7 TFLOP/s) would be 3.41 ms. The bytes, 616.6 MB in and 822.1 MB
// out, take 0.43 ms at 3.35 TB/s. So operations bound it. This is a first,
// simple kernel: a tile's load, conv1 and conv2 are separated by block
// barriers, with one block an SM (197.6 KB of shared memory) and nothing
// to overlap them.
//
// tfy2_fused_stem_f32 returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;   // stage-2 output rows a tile
constexpr int kTileCols = 16;  // stage-2 output columns a tile
constexpr int kC1 = 32;
constexpr int kC2 = 64;
constexpr int kK1 = 27;       // conv1's K: 3 x 3 taps x 3 channels
constexpr int kK2 = 9 * kC1;  // conv2's K: 288

// the stage-1 map of a tile with conv2's halo; columns of one parity
// together, kP1Stride floats a pixel
constexpr int kP1Rows = 2 * kTileRows + 2;  // 18
constexpr int kP1Cols = 2 * kTileCols + 2;  // 34
constexpr int kP1Half = kP1Cols / 2;        // 17
constexpr int kP1Stride = kC1 + 4;          // 36: 9 bank groups of 16 bytes
constexpr int kP1RowFloats = kP1Cols * kP1Stride;
constexpr int kP1Pixels = kP1Rows * kP1Cols;  // 612
static_assert(kP1Cols % 2 == 0, "the map splits into even and odd columns");
static_assert((kP1Stride / 4) % 2 == 1, "pixels 16 bytes x odd apart");
// the input patch: conv1's pre-pool pixels of p1 plus conv1's halo
constexpr int kInRows = 2 * kP1Rows + 2;  // 38
constexpr int kInCols = 2 * kP1Cols + 2;  // 70
constexpr int kInRowFloats = 3 * kInCols;  // 210
constexpr int kInFloats = kInRows * kInRowFloats;  // 7980
constexpr int kInLoads = (kInFloats + kThreads - 1) / kThreads;  // 16 a thread

// conv1's work: 4 groups of 8 channels x the p1 pixels, padded to whole
// warps so that a warp's threads share one group
constexpr int kG1 = 8;
constexpr int kG1Slots = (kP1Pixels + 31) / 32 * 32;  // 640
constexpr int kG1Items = (kC1 / kG1) * kG1Slots;
// conv2's work: a warp is 2 output rows x 16 columns of one group of 16
// channels
constexpr int kG2 = 16;
constexpr int kG2Groups = kC2 / kG2;  // 4
static_assert(kWarps == kG2Groups * kTileRows / 2 && kTileCols == 16,
              "conv2: one warp a group of channels and two output rows");

// shared memory, in floats; every region starts 16-byte aligned
constexpr int kOffW2 = 0;
constexpr int kOffW1 = kOffW2 + kK2 * kC2;  // 18432
constexpr int kOffB1 = kOffW1 + kK1 * kC1;  // + 864
constexpr int kOffB2 = kOffB1 + kC1;
constexpr int kOffP1 = kOffB2 + kC2;
constexpr int kOffIn = kOffP1 + kP1Rows * kP1RowFloats;
constexpr int kSmemBytes = (kOffIn + kInFloats) * 4;  // 197616
static_assert(kOffW1 % 4 == 0 && kOffB1 % 4 == 0 && kOffB2 % 4 == 0 &&
                  kOffP1 % 4 == 0 && kOffIn % 4 == 0,
              "float4 regions");

constexpr int kMaxDevices = 64;

// bias, then leaky max(0.1 v, v), in float32 with no contraction
__device__ __forceinline__ float bias_leaky(float v, float bias) {
  v = __fadd_rn(v, bias);
  return fmaxf(__fmul_rn(0.1f, v), v);
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float* acc, float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// where p1 local column j lies among the stored columns
__device__ __forceinline__ int p1_column(int j) { return (j & 1) * kP1Half + (j >> 1); }

__global__ void __launch_bounds__(kThreads, 1)
stem_f32_kernel(const float* __restrict__ x, const float4* __restrict__ w1,
                const float* __restrict__ b1, const float4* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int N, int H,
                int W, int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float4* sw2 = reinterpret_cast<float4*>(smem + kOffW2);
  float4* sw1 = reinterpret_cast<float4*>(smem + kOffW1);
  float* sb1 = smem + kOffB1;
  float* sb2 = smem + kOffB2;
  float* sp1 = smem + kOffP1;
  float* sxin = smem + kOffIn;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kK2 * kC2 / 4; i += kThreads) sw2[i] = w2[i];
  for (int i = tid; i < kK1 * kC1 / 4; i += kThreads) sw1[i] = w1[i];
  if (tid < kC1) sb1[tid] = b1[tid];
  if (tid < kC2) sb2[tid] = b2[tid];

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int per_image = tiles_y * tiles_x;
  const int tiles = N * per_image;

  // conv2: this thread's output pixel (r2, c2) of the tile and channels
  // g2 * 16 ... g2 * 16 + 15
  const int g2 = warp % kG2Groups;
  const int r2 = 2 * (warp / kG2Groups) + (lane >> 4);
  const int c2 = lane & 15;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / per_image;
    const int ty = (tile - n * per_image) / tiles_x;
    const int tx = tile - n * per_image - ty * tiles_x;
    const int oy0 = ty * kTileRows, ox0 = tx * kTileCols;

    __syncthreads();  // the weights are in; the last tile is done with sp1

    // the input patch: global rows 4*oy0 - 3 ..., columns 4*ox0 - 3 ...,
    // a patch row's 70 pixels x 3 channels contiguous as in x; all loads
    // issued before the stores, zeros outside the image
    {
      const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;
      float v[kInLoads];
#pragma unroll
      for (int u = 0; u < kInLoads; ++u) {
        const int e = tid + u * kThreads;
        const int r = e / kInRowFloats, q = e - r * kInRowFloats;
        const int gy = iy0 + r, gx = ix0 + q / 3;
        v[u] = 0.0f;
        if (e < kInFloats && static_cast<unsigned>(gy) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(gx) < static_cast<unsigned>(W))
          v[u] = __ldg(x + (static_cast<long long>(n) * H + gy) * (3LL * W) + 3LL * ix0 + q);
      }
#pragma unroll
      for (int u = 0; u < kInLoads; ++u) {
        const int e = tid + u * kThreads;
        if (e < kInFloats) sxin[e] = v[u];
      }
    }
    __syncthreads();

    // conv1 + pool: p1 local (i, j) is global p1 (2*oy0 - 1 + i, 2*ox0 - 1
    // + j); its pre-pool pixels (2i + a, 2j + b) read the input patch at
    // (2i + a + dy, 2j + b + dx) for tap (dy, dx)
    const int py0 = 2 * oy0 - 1, px0 = 2 * ox0 - 1;
    for (int item = tid; item < kG1Items; item += kThreads) {
      const int grp = item / kG1Slots, pix = item - grp * kG1Slots;
      if (pix >= kP1Pixels) continue;
      const int i = pix / kP1Cols, j = pix - i * kP1Cols;
      float4* dst = reinterpret_cast<float4*>(sp1 + i * kP1RowFloats +
                                              p1_column(j) * kP1Stride + grp * kG1);
      const int gy = py0 + i, gx = px0 + j;
      if (gy < 0 || gy >= H2 || gx < 0 || gx >= W2) {
        dst[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        continue;
      }
      float win[4][4][3];
      const float* src = sxin + 2 * i * kInRowFloats + 2 * j * 3;
#pragma unroll
      for (int dy = 0; dy < 4; ++dy)
#pragma unroll
        for (int dx = 0; dx < 4; ++dx)
#pragma unroll
          for (int c = 0; c < 3; ++c) win[dy][dx][c] = src[dy * kInRowFloats + dx * 3 + c];
      float acc[4][kG1];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int o = 0; o < kG1; ++o) acc[p][o] = 0.0f;
#pragma unroll
      for (int k = 0; k < kK1; ++k) {
        const int dy = k / 9, dx = (k / 3) % 3, c = k % 3;
        const float4 wa = sw1[k * (kC1 / 4) + grp * 2];
        const float4 wb = sw1[k * (kC1 / 4) + grp * 2 + 1];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float v = win[(p >> 1) + dy][(p & 1) + dx][c];
          fma4(acc[p], v, wa);
          fma4(acc[p] + 4, v, wb);
        }
      }
      float m[kG1];
#pragma unroll
      for (int o = 0; o < kG1; ++o)
        m[o] = bias_leaky(fmaxf(fmaxf(acc[0][o], acc[1][o]), fmaxf(acc[2][o], acc[3][o])),
                          sb1[grp * kG1 + o]);
      dst[0] = make_float4(m[0], m[1], m[2], m[3]);
      dst[1] = make_float4(m[4], m[5], m[6], m[7]);
    }
    __syncthreads();

    // conv2 + pool: output (r2, c2) is the max over its quad (a, b) of
    // conv2 at p1 local (2*r2 + a, 2*c2 + b), whose tap (dy, dx) reads p1
    // local (2*r2 + a + dy, 2*c2 + b + dx)
    {
      float acc[4][kG2];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int o = 0; o < kG2; ++o) acc[p][o] = 0.0f;
      const float* row0 = sp1 + 2 * r2 * kP1RowFloats;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * dy;
        const float* px[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          px[p] = row0 + ((p >> 1) + dy) * kP1RowFloats +
                  p1_column(2 * c2 + (p & 1) + dx) * kP1Stride;
        const float4* wt = sw2 + tap * kC1 * (kC2 / 4) + g2 * (kG2 / 4);
#pragma unroll 2
        for (int c4 = 0; c4 < kC1 / 4; ++c4) {
          float4 v[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) v[p] = *reinterpret_cast<const float4*>(px[p] + 4 * c4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4* wk = wt + (4 * c4 + kk) * (kC2 / 4);
            const float4 w0 = wk[0], w1v = wk[1], w2v = wk[2], w3 = wk[3];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float s = component(v[p], kk);
              fma4(acc[p], s, w0);
              fma4(acc[p] + 4, s, w1v);
              fma4(acc[p] + 8, s, w2v);
              fma4(acc[p] + 12, s, w3);
            }
          }
        }
      }
      const int oy = oy0 + r2, ox = ox0 + c2;
      if (oy < H4 && ox < W4) {
        float m[kG2];
#pragma unroll
        for (int o = 0; o < kG2; ++o)
          m[o] = bias_leaky(fmaxf(fmaxf(acc[0][o], acc[1][o]), fmaxf(acc[2][o], acc[3][o])),
                            sb2[g2 * kG2 + o]);
        float4* o4 = reinterpret_cast<float4*>(
            out + ((static_cast<size_t>(n) * H4 + oy) * W4 + ox) * kC2 + g2 * kG2);
#pragma unroll
        for (int q = 0; q < kG2 / 4; ++q)
          o4[q] = make_float4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
      }
    }
  }
}

}  // namespace

// x (N, H, W, 3) float32; w1 (3, 3, 3, 32), b1 (32,), w2 (3, 3, 32, 64),
// b2 (64,) float32 (the HWIO kernels); out (N, H/4, W/4, 64) float32. All
// contiguous, on the current device; w1, w2 and out 16-byte aligned. H and
// W multiples of 4.
extern "C" cudaError_t tfy2_fused_stem_f32(const void* x, const void* w1, const void* b1,
                                           const void* w2, const void* b2, void* out,
                                           int N, int H, int W, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // per device, set once: the shared memory above 48 KB, and the grid
  static int blocks_per_device[kMaxDevices] = {};
  if (blocks_per_device[dev] == 0) {
    err = cudaFuncSetAttribute(stem_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_f32_kernel, kThreads,
                                                        kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    blocks_per_device[dev] = per_sm * sms;
  }
  const int tiles_y = (H / 4 + kTileRows - 1) / kTileRows;
  const int tiles_x = (W / 4 + kTileCols - 1) / kTileCols;
  const long long tiles = static_cast<long long>(N) * tiles_y * tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = tiles < blocks_per_device[dev] ? static_cast<int>(tiles)
                                                  : blocks_per_device[dev];
  stem_f32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float4*>(w1),
      static_cast<const float*>(b1), static_cast<const float4*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), N, H, W, tiles_y, tiles_x);
  return cudaGetLastError();
}
