// Fused Darknet19 stem, written for Hopper (sm_90a): conv1 3x3 3->32 + bias +
// leaky + 2x2 max pool, then conv2 3x3 32->64 + bias + leaky + 2x2 max pool,
// SAME padding, BN folded into the kernels and biases.
//
// Replaces tensorflow_yolo2_tpu/ops/pallas_stem.py: fused_stem / _stem_kernel.
//
// Input x (N, H, W, 3) bfloat16, H and W multiples of 4. Output
// (N, H/4, W/4, 64) bfloat16. The weights come packed by the wrapper
// (ops/cuda_stem.py::pack_stem_weights) in the order of mma.sync's B
// fragments: (K/16, O/8, 32 lanes, 4) bfloat16, where K = 9*C indexes the
// HWIO kernel reshaped to (9C, O), k = (dy*3 + dx)*C + c, zero-padded from
// 27 to 32 for conv1. Biases are float32.
//
// Numerics, as _stem_kernel's: bf16 products, float32 sums (the order of
// the sums is the tensor cores'); bias and leaky max(0.1 x, x) in float32;
// the stage-1 map rounded to bf16 once, the output rounded to bf16 once.
// The pool is taken before the bias and the leaky: both are monotone, and
// so is float32 rounding, so the order gives the same bits.
//
// Work split. A block walks over tiles (a persistent grid of as many blocks
// as fit on the card); a tile is one image's 8 x 16 stage-2 output pixels.
// For a tile the block loads the 38 x 74 x 3 input patch it needs into
// shared memory (zeros outside the image), computes the stage-1 map p1 over
// the tile plus a one-pixel halo, 18 x 34 x 32 in bf16, into shared memory
// (a halo pixel outside the image is 0, conv2's SAME padding, not
// leaky(b1)), then conv2 over p1 with the pool, bias and leaky in the
// epilogue, writing NHWC bf16. The 448^2 x 32 conv1 activation never
// reaches device memory.
//
// Both convs are implicit GEMMs on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 accumulators). An M tile of 16 rows is 8 neighbouring
// pixels of one row and the 8 below them, so the 2x2 pool is a max of a
// thread's own two rows and a shuffle with the lane 4 away. conv1 gathers
// its A fragments from the input patch (27 taps padded to K=32); conv2 reads
// them with ldmatrix from p1, whose pixels are 80 bytes apart so that the
// eight rows of a matrix fall in distinct banks.
//
// Bound: at batch 256, 448^2 the work is 562 GFLOP (conv1 0.347 + conv2
// 1.850 GFLOP an image), 0.57 ms at 989 TFLOP/s bf16; the bytes, 2.81 MB an
// image in and out, take 0.21 ms at 3.35 TB/s. So operations bound it. This
// first version recomputes a 1.27x halo of conv1, pads conv1's K from 27 to
// 32, feeds the tensor cores with mma.sync rather than wgmma, and does not
// overlap a tile's loads with the previous tile's math.
//
// tfy2_fused_stem returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;   // stage-2 output rows a tile
constexpr int kTileCols = 16;  // stage-2 output columns a tile
constexpr int kC1 = 32;
constexpr int kC2 = 64;

// the stage-1 map of a tile with conv2's halo
constexpr int kP1Rows = 2 * kTileRows + 2;   // 18
constexpr int kP1Cols = 2 * kTileCols + 2;   // 34 kept
constexpr int kP1Groups = (kP1Cols + 3) / 4;  // 9 groups of 4 computed
constexpr int kP1Stride = kC1 + 8;           // bf16 a pixel: 80 bytes
// the input patch: conv1's pre-pool pixels of p1 plus conv1's halo
constexpr int kInRows = 2 * kP1Rows + 2;       // 38
constexpr int kInCols = 8 * kP1Groups + 2;     // 74

constexpr int kK1Steps = 2;           // conv1: K = 27 padded to 32
constexpr int kN1Tiles = kC1 / 8;     // 4
constexpr int kK2Steps = 9 * kC1 / 16;  // conv2: K = 288, 18 steps
constexpr int kN2Tiles = kC2 / 8;     // 8
constexpr int kM1Tiles = kP1Rows * kP1Groups;            // 162
constexpr int kM2Cols = 2 * kTileCols / 8;  // conv2 M tiles across a tile: 4
constexpr int kM2Tiles = kTileRows * kM2Cols;  // 32
constexpr int kM2PerPass = 2;  // conv2 M tiles a warp holds at once
static_assert(kM2Tiles % (kWarps * kM2PerPass) == 0, "conv2 M tiles per warp");

// shared memory, in bytes
constexpr int kW2Bytes = kK2Steps * kN2Tiles * 32 * 8;  // 36864
constexpr int kW1Bytes = kK1Steps * kN1Tiles * 32 * 8;  // 2048
constexpr int kBiasBytes = (kC1 + kC2) * 4;
constexpr int kP1Bytes = kP1Rows * kP1Cols * kP1Stride * 2;  // 48960
constexpr int kInBytes = kInRows * kInCols * 3 * 2;          // 16872
constexpr int kOffW1 = kW2Bytes;
constexpr int kOffBias = kOffW1 + kW1Bytes;
constexpr int kOffP1 = kOffBias + kBiasBytes;
constexpr int kOffIn = kOffP1 + kP1Bytes;
constexpr int kSmemBytes = kOffIn + kInBytes;  // 105128
static_assert(kOffP1 % 16 == 0, "ldmatrix rows are 16-byte aligned");
static_assert((kP1Stride * 2) % 16 == 0, "ldmatrix rows are 16-byte aligned");

constexpr int kMaxDevices = 64;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// bias, leaky max(0.1 v, v) in float32 (no FMA), two channels rounded to
// bf16 and packed, the lower channel in the low half
__device__ __forceinline__ uint32_t epilogue(float v0, float v1, float bias0,
                                             float bias1) {
  v0 = __fadd_rn(v0, bias0);
  v1 = __fadd_rn(v1, bias1);
  v0 = fmaxf(__fmul_rn(0.1f, v0), v0);
  v1 = fmaxf(__fmul_rn(0.1f, v1), v1);
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The 2x2 max of an M tile's accumulators: rows g and g + 8 in the thread,
// columns g and g^1 in lanes 4 apart. Valid in lanes with even g.
__device__ __forceinline__ void pool2(const float (&acc)[4], float& v0, float& v1) {
  v0 = fmaxf(acc[0], acc[2]);
  v1 = fmaxf(acc[1], acc[3]);
  v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
  v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
}

__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const uint16_t* __restrict__ x, const uint2* __restrict__ w1f,
            const float* __restrict__ b1, const uint2* __restrict__ w2f,
            const float* __restrict__ b2, uint16_t* __restrict__ out, int N,
            int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* sw2 = reinterpret_cast<uint2*>(smem);
  uint2* sw1 = reinterpret_cast<uint2*>(smem + kOffW1);
  float* sb1 = reinterpret_cast<float*>(smem + kOffBias);
  float* sb2 = sb1 + kC1;
  uint16_t* sp1 = reinterpret_cast<uint16_t*>(smem + kOffP1);
  uint16_t* sxin = reinterpret_cast<uint16_t*>(smem + kOffIn);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row group
  const int t = lane & 3;   // the thread in the group

  for (int i = tid; i < kW2Bytes / 8; i += kThreads) sw2[i] = w2f[i];
  for (int i = tid; i < kW1Bytes / 8; i += kThreads) sw1[i] = w1f[i];
  for (int i = tid; i < kC1; i += kThreads) sb1[i] = b1[i];
  for (int i = tid; i < kC2; i += kThreads) sb2[i] = b2[i];

  // conv1's A fragment: this lane's 8 values of k (4 a K step) and where
  // each lies in the input patch relative to the pixel; k >= 27 is padding
  int koff[8];
  bool kval[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = (q >= 4 ? 16 : 0) + 2 * t + (q & 1) + ((q & 2) ? 8 : 0);
    const int tap = k / 3;
    kval[q] = k < 27;
    koff[q] = kval[q] ? ((tap / 3) * kInCols + tap % 3) * 3 + k % 3 : 0;
  }

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int per_image = tiles_y * tiles_x;
  const int tiles = N * per_image;
  const uint32_t p1_base = static_cast<uint32_t>(__cvta_generic_to_shared(sp1));

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / per_image;
    const int ty = (tile - n * per_image) / tiles_x;
    const int tx = tile - n * per_image - ty * tiles_x;
    const int oy0 = ty * kTileRows, ox0 = tx * kTileCols;

    __syncthreads();  // the weights are in; the last tile is done with sxin, sp1

    // input patch: global rows 4*oy0 - 3 ..., columns 4*ox0 - 3 ...
    {
      const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;
      const uint16_t* xn = x + static_cast<size_t>(n) * H * W * 3;
      for (int i = tid; i < kInRows * kInCols * 3; i += kThreads) {
        const int r = i / (kInCols * 3);
        const int c3 = i - r * (kInCols * 3);
        const int gy = iy0 + r, gx = ix0 + c3 / 3;
        uint16_t v = 0;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = xn[static_cast<size_t>(gy) * W * 3 + ix0 * 3 + c3];
        sxin[i] = v;
      }
    }
    __syncthreads();

    // stage 1: p1 local (i, j) is global p1 (2*oy0 - 1 + i, 2*ox0 - 1 + j);
    // its pre-pool conv1 pixels are local (2i + a, 2j + b), whose 3x3 taps
    // are input-patch pixels (2i + a + dy, 2j + b + dx)
    const int py0 = 2 * oy0 - 1, px0 = 2 * ox0 - 1;
    for (int mt = warp; mt < kM1Tiles; mt += kWarps) {
      const int pr = mt / kP1Groups, pg = mt - pr * kP1Groups;
      const int base0 = ((2 * pr) * kInCols + 8 * pg + g) * 3;
      const int base1 = base0 + kInCols * 3;
      float acc[kN1Tiles][4] = {};
#pragma unroll
      for (int s = 0; s < kK1Steps; ++s) {
        uint16_t e0[4], e1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * s + j;
          e0[j] = kval[q] ? sxin[base0 + koff[q]] : uint16_t(0);
          e1[j] = kval[q] ? sxin[base1 + koff[q]] : uint16_t(0);
        }
        const uint32_t a0 = pack_bits(e0[0], e0[1]), a1 = pack_bits(e1[0], e1[1]);
        const uint32_t a2 = pack_bits(e0[2], e0[3]), a3 = pack_bits(e1[2], e1[3]);
#pragma unroll
        for (int nt = 0; nt < kN1Tiles; ++nt) {
          const uint2 b = sw1[(s * kN1Tiles + nt) * 32 + lane];
          mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
        }
      }
      const int pc = 4 * pg + (g >> 1);
      const int gy = py0 + pr, gx = px0 + pc;
      const bool inside = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
      const bool keep = (g & 1) == 0 && pc < kP1Cols;
#pragma unroll
      for (int nt = 0; nt < kN1Tiles; ++nt) {
        float v0, v1;
        pool2(acc[nt], v0, v1);
        const int ch = nt * 8 + 2 * t;
        if (keep)
          *reinterpret_cast<uint32_t*>(sp1 + (pr * kP1Cols + pc) * kP1Stride + ch) =
              inside ? epilogue(v0, v1, sb1[ch], sb1[ch + 1]) : 0u;
      }
    }
    __syncthreads();

    // stage 2: conv2 pixel local (r, c) is global p1 (2*oy0 + r, 2*ox0 + c);
    // tap (dy, dx) reads p1 local (r + dy, c + dx). M tile mt covers rows
    // 2*(mt/kM2Cols) and the one below, columns 8*(mt%kM2Cols) ... + 7.
    const int m = lane & 15;
    for (int pass = 0; pass < kM2Tiles / (kWarps * kM2PerPass); ++pass) {
      uint32_t aaddr[kM2PerPass];
#pragma unroll
      for (int mi = 0; mi < kM2PerPass; ++mi) {
        const int mt = warp + kWarps * (kM2PerPass * pass + mi);
        const int r = 2 * (mt / kM2Cols) + (m >> 3), c = 8 * (mt % kM2Cols) + (m & 7);
        aaddr[mi] = p1_base + ((r * kP1Cols + c) * kP1Stride + (lane >> 4) * 8) * 2;
      }
      float acc[kM2PerPass][kN2Tiles][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t toff = ((tap / 3) * kP1Cols + tap % 3) * kP1Stride * 2;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const int s = 2 * tap + kc;
          uint2 b[kN2Tiles];
#pragma unroll
          for (int nt = 0; nt < kN2Tiles; ++nt) b[nt] = sw2[(s * kN2Tiles + nt) * 32 + lane];
#pragma unroll
          for (int mi = 0; mi < kM2PerPass; ++mi) {
            uint32_t a[4];
            ldmatrix_x4(a, aaddr[mi] + toff + kc * 32);
#pragma unroll
            for (int nt = 0; nt < kN2Tiles; ++nt)
              mma_bf16(acc[mi][nt], a[0], a[1], a[2], a[3], b[nt].x, b[nt].y);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < kM2PerPass; ++mi) {
        const int mt = warp + kWarps * (kM2PerPass * pass + mi);
        const int oy = oy0 + mt / kM2Cols, ox = ox0 + 4 * (mt % kM2Cols) + (g >> 1);
        const bool keep = (g & 1) == 0 && oy < H4 && ox < W4;
        uint16_t* o = out + ((static_cast<size_t>(n) * H4 + oy) * W4 + ox) * kC2;
#pragma unroll
        for (int nt = 0; nt < kN2Tiles; ++nt) {
          float v0, v1;
          pool2(acc[mi][nt], v0, v1);
          const int ch = nt * 8 + 2 * t;
          if (keep)
            *reinterpret_cast<uint32_t*>(o + ch) = epilogue(v0, v1, sb2[ch], sb2[ch + 1]);
        }
      }
    }
  }
}

}  // namespace

// x (N, H, W, 3) bf16; w1f (2, 4, 32, 4) and w2f (18, 8, 32, 4) bf16 B
// fragments; b1 (32,), b2 (64,) float32; out (N, H/4, W/4, 64) bf16. All
// contiguous, on the current device. H and W multiples of 4.
extern "C" cudaError_t tfy2_fused_stem(const void* x, const void* w1f, const void* b1,
                                       const void* w2f, const void* b2, void* out, int N,
                                       int H, int W, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // per device, set once: the shared memory above 48 KB, and the grid
  static int blocks_per_device[kMaxDevices] = {};
  if (blocks_per_device[dev] == 0) {
    err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel, kThreads,
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
  stem_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint2*>(w1f),
      static_cast<const float*>(b1), static_cast<const uint2*>(w2f),
      static_cast<const float*>(b2), static_cast<uint16_t*>(out), N, H, W, tiles_y,
      tiles_x);
  return cudaGetLastError();
}
