// Fused Darknet19 stem, written for Hopper (sm_90a): conv1 3x3 3->32 + bias +
// leaky + 2x2 max pool, then conv2 3x3 32->64 + bias + leaky + 2x2 max pool,
// SAME padding, BN folded into the kernels and biases.
//
// Replaces tensorflow_yolo2_tpu/ops/pallas_stem.py: fused_stem / _stem_kernel
// in bf16. Its float32 sibling, for float32 images, is stem_f32.cu (B4-f32,
// the same tiles on the FMA units).
//
// Input x (N, H, W, 3) bfloat16, H and W multiples of 4. Output
// (N, H/4, W/4, 64) bfloat16. The weights come packed by the wrapper
// (ops/cuda_stem.py::pack_stem_weights); both kernels are the HWIO kernel
// reshaped to (K, O), K = 9*C, k = (dy*3 + dx)*C + c. conv1's comes in the
// order of mma.sync's B fragments, (2, 4, 32 lanes, 4) bfloat16, K
// zero-padded from 27 to 32. conv2's comes in wgmma's K-major layout
// without swizzle: 8 x 8 core matrices (8 columns n, 16 bytes of k each,
// 128 contiguous bytes) at byte (s*8 + n/8)*256 + ((k%16)/8)*128 for k
// step s = k/16: (18, 8, 2, 8, 8) bfloat16. Biases are float32.
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
// conv1 is an implicit GEMM on mma.sync m16n8k16 (bf16 in, float32
// accumulators): an M tile of 16 rows is 8 neighbouring pixels of one row
// and the 8 below them, so the 2x2 pool is a max of a thread's own two rows
// and a shuffle with the lane 4 away; each lane gathers its A fragments
// from the input patch (27 taps padded to K = 32) and keeps its B
// fragments (16 registers) and biases in registers for the life of the
// block. conv2 runs on wgmma m64n64k16 with A from registers: a warpgroup
// takes one pair of pre-pool rows x 32 columns, four such M tiles, one a
// warp, each loaded with ldmatrix from p1 (pixels 80 bytes apart, so that
// the eight rows of a matrix fall in distinct banks); B, conv2's weights,
// is read by the tensor cores from shared memory through a descriptor. A
// warp's accumulators are laid out as mma.sync's are for each n8 chunk,
// so the pool and epilogue are the same for both convs. The input patch
// is loaded in 4-byte words, all of a thread's loads issued before its
// stores.
//
// Bound: at batch 256, 448^2 the work is 562 GFLOP (conv1 0.347 + conv2
// 1.850 GFLOP an image), 0.57 ms at 989 TFLOP/s bf16; the bytes, 2.81 MB an
// image in and out, take 0.21 ms at 3.35 TB/s. So operations bound it.
//
// What wgmma changed: with mma.sync every warp re-read conv2's B
// fragments from shared memory for each K step (1.5 shared-memory
// wavefronts a m16n8k16); now the tensor cores read B once a warpgroup
// and K step. With conv1's weights in registers and the word-wide load,
// the kernel went from 2.78 to 1.91 ms at batch 256, 448^2 (chip_smoke.py,
// NVIDIA H100 80GB HBM3 at 700 W). What is left: conv1, 16% of the work,
// takes the largest share of the time (chip_smoke.py --stem-ab times each
// phase alone and left out), with its K padded from 27 to 32, its halo
// recomputed 1.27x and its gather and epilogue issued by every lane; a
// tile's load, conv1 and conv2 are separated by block barriers and overlap
// only with the SM's other block (no TMA or cp.async pipeline, no warp
// specialisation).
//
// tfy2_fused_stem returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpGroups = kWarps / 4;
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
// a patch row in shared memory: one bf16 before column 0, so that a row
// starts where a 4-byte word of x does, then 74 x 3 values and one after
constexpr int kInStride = 3 * kInCols + 2;     // 224 bf16
constexpr int kInWords = kInStride / 2;        // 112 words a row
constexpr int kInLoaders = 2 * kInWords;       // threads of the load: 2 rows
static_assert(kInRows % 2 == 0 && kInLoaders <= kThreads, "the input load's rows");

constexpr int kK1Steps = 2;           // conv1: K = 27 padded to 32
constexpr int kN1Tiles = kC1 / 8;     // 4
constexpr int kK2Steps = 9 * kC1 / 16;  // conv2: K = 288, 18 steps
constexpr int kN2Tiles = kC2 / 8;     // 8
constexpr int kM1Tiles = kP1Rows * kP1Groups;  // 162
// conv2: a warpgroup's 64 rows are one output row's pair of pre-pool rows
// x 32 columns; warp w of the group holds columns 8w ... 8w + 7
static_assert(2 * kTileCols == 4 * 8, "a warpgroup spans a tile's width");
static_assert(kTileRows % kWarpGroups == 0, "row pairs per warpgroup");

// conv2's weights in wgmma's K-major layout without swizzle
constexpr int kW2Lbo = 128;  // bytes to the next core matrix along K
constexpr int kW2Sbo = 256;  // bytes to the next core matrix along N
constexpr int kW2StepBytes = kN2Tiles * kW2Sbo;  // one K step of 16: 2048

// shared memory, in bytes
constexpr int kW2Bytes = kK2Steps * kW2StepBytes;  // 36864
constexpr int kP1Bytes = kP1Rows * kP1Cols * kP1Stride * 2;  // 48960
constexpr int kInBytes = kInRows * kInStride * 2;            // 17024
constexpr int kOffP1 = kW2Bytes;
constexpr int kOffIn = kOffP1 + kP1Bytes;
constexpr int kSmemBytes = kOffIn + kInBytes;  // 102848
static_assert(kOffP1 % 16 == 0, "ldmatrix rows are 16-byte aligned");
static_assert(kOffIn % 4 == 0, "the input patch is stored in words");
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

// wgmma's shared-memory matrix descriptor for conv2's B at shared address
// addr: start >> 4, LBO and SBO >> 4, base offset 0, no swizzle
__device__ __forceinline__ uint64_t w2_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         (static_cast<uint64_t>(kW2Lbo >> 4) << 16) |
         (static_cast<uint64_t>(kW2Sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d += A B for the warpgroup's 64 x 16 A (this warp's 16 rows in a, as
// mma.sync's A fragment) and the 16 x 64 B at descriptor desc
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[kN2Tiles][4],
                                                const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keeps the compiler from reading the accumulators before wgmma.wait_group
__device__ __forceinline__ void fence_accumulators(float (&d)[kN2Tiles][4]) {
#pragma unroll
  for (int i = 0; i < kN2Tiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
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
            const float* __restrict__ b1, const uint4* __restrict__ w2t,
            const float* __restrict__ b2, uint16_t* __restrict__ out, int N,
            int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sw2 = reinterpret_cast<uint4*>(smem);
  uint16_t* sp1 = reinterpret_cast<uint16_t*>(smem + kOffP1);
  uint16_t* sxin = reinterpret_cast<uint16_t*>(smem + kOffIn);
  uint32_t* sxin_words = reinterpret_cast<uint32_t*>(smem + kOffIn);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row group
  const int t = lane & 3;   // the thread in the group

  for (int i = tid; i < kW2Bytes / 16; i += kThreads) sw2[i] = w2t[i];
  // wgmma reads sw2 through the async proxy: order these stores before it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // conv1's B fragments, in registers for the life of the block
  uint2 w1r[kK1Steps][kN1Tiles];
#pragma unroll
  for (int s = 0; s < kK1Steps; ++s)
#pragma unroll
    for (int nt = 0; nt < kN1Tiles; ++nt) w1r[s][nt] = w1f[(s * kN1Tiles + nt) * 32 + lane];

  // the biases of this lane's channels nt*8 + 2t, + 1 of each conv
  float bias1[kN1Tiles][2];
#pragma unroll
  for (int nt = 0; nt < kN1Tiles; ++nt) {
    bias1[nt][0] = b1[nt * 8 + 2 * t];
    bias1[nt][1] = b1[nt * 8 + 2 * t + 1];
  }
  float bias2[kN2Tiles][2];
#pragma unroll
  for (int nt = 0; nt < kN2Tiles; ++nt) {
    bias2[nt][0] = b2[nt * 8 + 2 * t];
    bias2[nt][1] = b2[nt * 8 + 2 * t + 1];
  }

  // conv1's A fragment: this lane's 8 values of k (4 a K step) and where
  // each lies in the input patch relative to the pixel; k >= 27 is padding
  int koff[8];
  bool kval[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = (q >= 4 ? 16 : 0) + 2 * t + (q & 1) + ((q & 2) ? 8 : 0);
    const int tap = k / 3;
    kval[q] = k < 27;
    koff[q] = kval[q] ? (tap / 3) * kInStride + (tap % 3) * 3 + k % 3 : 0;
  }

  // the input load: thread tid < kInLoaders moves word lw of patch rows
  // lr, lr + 2, ...; the word's two values are of patch columns lpx0 and
  // lpx1 (-1: the value before column 0)
  const int lw = tid % kInWords, lr = tid / kInWords;
  const int lpx0 = lw == 0 ? -1 : (2 * lw - 1) / 3, lpx1 = 2 * lw / 3;

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int per_image = tiles_y * tiles_x;
  const int tiles = N * per_image;
  const uint32_t p1_base = static_cast<uint32_t>(__cvta_generic_to_shared(sp1));
  const uint64_t w2_desc =
      w2_descriptor(static_cast<uint32_t>(__cvta_generic_to_shared(sw2)));

  // conv2: warpgroup wg takes row pairs wg, wg + kWarpGroups, ...; this
  // lane's ldmatrix row of its warp's M tile in the first row pair
  const int wg = warp >> 2, wl = warp & 3;
  const int m = lane & 15;
  const uint32_t a2_lane =
      p1_base +
      (((m >> 3) * kP1Cols + 8 * wl + (m & 7)) * kP1Stride + (lane >> 4) * 8) * 2;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / per_image;
    const int ty = (tile - n * per_image) / tiles_x;
    const int tx = tile - n * per_image - ty * tiles_x;
    const int oy0 = ty * kTileRows, ox0 = tx * kTileCols;

    __syncthreads();  // the weights are in; the last tile is done with sxin, sp1

    // input patch: global rows 4*oy0 - 3 ..., columns 4*ox0 - 3 ...; the
    // value before column 0 of a patch row starts a word of x (W and the
    // 3 channels make a row an even count of values, 3*ix0 - 1 is even).
    // All loads are issued before the stores; zeros outside the image.
    if (tid < kInLoaders) {
      const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;
      const bool col0 = static_cast<unsigned>(ix0 + lpx0) < static_cast<unsigned>(W);
      const bool col1 = static_cast<unsigned>(ix0 + lpx1) < static_cast<unsigned>(W);
      const long long row_values = 3LL * W;
      const long long first =
          (static_cast<long long>(n) * H + iy0 + lr) * row_values + 3 * ix0 - 1 + 2 * lw;
      uint32_t v[kInRows / 2];
#pragma unroll
      for (int i = 0; i < kInRows / 2; ++i) {
        const long long at = first + 2 * i * row_values;
        v[i] = 0;
        if (static_cast<unsigned>(iy0 + lr + 2 * i) < static_cast<unsigned>(H)) {
          if (col0 && col1)
            v[i] = *reinterpret_cast<const uint32_t*>(x + at);
          else
            v[i] = pack_bits(col0 ? x[at] : uint16_t(0), col1 ? x[at + 1] : uint16_t(0));
        }
      }
#pragma unroll
      for (int i = 0; i < kInRows / 2; ++i) sxin_words[(lr + 2 * i) * kInWords + lw] = v[i];
    }
    __syncthreads();

    // stage 1: p1 local (i, j) is global p1 (2*oy0 - 1 + i, 2*ox0 - 1 + j);
    // its pre-pool conv1 pixels are local (2i + a, 2j + b), whose 3x3 taps
    // are input-patch pixels (2i + a + dy, 2j + b + dx)
    const int py0 = 2 * oy0 - 1, px0 = 2 * ox0 - 1;
    for (int mt = warp; mt < kM1Tiles; mt += kWarps) {
      const int pr = mt / kP1Groups, pg = mt - pr * kP1Groups;
      const int base0 = 2 * pr * kInStride + 1 + (8 * pg + g) * 3;
      const int base1 = base0 + kInStride;
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
          mma_bf16(acc[nt], a0, a1, a2, a3, w1r[s][nt].x, w1r[s][nt].y);
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
              inside ? epilogue(v0, v1, bias1[nt][0], bias1[nt][1]) : 0u;
      }
    }
    __syncthreads();

    // stage 2: conv2 pixel local (r, c) is global p1 (2*oy0 + r, 2*ox0 + c);
    // tap (dy, dx) reads p1 local (r + dy, c + dx). Row pair rp is output
    // row oy0 + rp: pre-pool rows 2 rp and 2 rp + 1. A tap is two K steps
    // of 16 channels; each is committed as a group, and the wait for the
    // group before frees the A registers the next tap loads.
    for (int rp = wg; rp < kTileRows; rp += kWarpGroups) {
      const uint32_t aaddr = a2_lane + 2 * rp * kP1Cols * kP1Stride * 2;
      float acc[kN2Tiles][4];
#pragma unroll
      for (int nt = 0; nt < kN2Tiles; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t toff = ((tap / 3) * kP1Cols + tap % 3) * kP1Stride * 2;
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, aaddr + toff);
        ldmatrix_x4(a1, aaddr + toff + 32);
        wgmma_fence();
        wgmma_m64n64k16(acc, a0, w2_desc + (2 * tap) * (kW2StepBytes >> 4));
        wgmma_m64n64k16(acc, a1, w2_desc + (2 * tap + 1) * (kW2StepBytes >> 4));
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_accumulators(acc);
      const int oy = oy0 + rp, ox = ox0 + 4 * wl + (g >> 1);
      const bool keep = (g & 1) == 0 && oy < H4 && ox < W4;
      uint16_t* o = out + ((static_cast<size_t>(n) * H4 + oy) * W4 + ox) * kC2;
#pragma unroll
      for (int nt = 0; nt < kN2Tiles; ++nt) {
        float v0, v1;
        pool2(acc[nt], v0, v1);
        const int ch = nt * 8 + 2 * t;
        if (keep)
          *reinterpret_cast<uint32_t*>(o + ch) = epilogue(v0, v1, bias2[nt][0], bias2[nt][1]);
      }
    }
  }
}

}  // namespace

// x (N, H, W, 3) bf16; w1f (2, 4, 32, 4) bf16 B fragments; w2t (18, 8, 2,
// 8, 8) bf16 wgmma B tiles; b1 (32,), b2 (64,) float32; out (N, H/4, W/4,
// 64) bf16. All contiguous, on the current device, x 4-byte aligned. H and
// W multiples of 4.
extern "C" cudaError_t tfy2_fused_stem(const void* x, const void* w1f, const void* b1,
                                       const void* w2t, const void* b2, void* out, int N,
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
      static_cast<const float*>(b1), static_cast<const uint4*>(w2t),
      static_cast<const float*>(b2), static_cast<uint16_t*>(out), N, H, W, tiles_y,
      tiles_x);
  return cudaGetLastError();
}
