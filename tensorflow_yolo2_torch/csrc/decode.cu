// YOLOv1 grid decode and decode + greedy NMS, written for Hopper (sm_90a).
//
// Replaces the two v1 Pallas kernels of tensorflow_yolo2_tpu/ops/pallas_decode.py:
//   tfy2_decode_grid  <- decode_grid_pallas / _decode_kernel
//   tfy2_decode_nms   <- decode_nms_pallas / _decode_nms_kernel + _nms_sweep
//
// Input is the head's NHWC grid, (N, S, S, C + 5B) float32, contiguous; each
// cell is [C class scores | B confidences | B * (x, y, w, h)]. The TPU
// kernels transpose it to channels-major rows for the lane layout; here a
// thread owns a cell (or a slot) and reads the cell's channels itself.
//
// Every arithmetic step uses the round-to-nearest intrinsics so that nvcc
// contracts nothing into an FMA and the division by S is the IEEE quotient:
// the results are bit-equal to the plain PyTorch versions of the same
// formulas (ops/cuda_decode.py), which the NMS survivor set depends on.
//
// Each launch function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kMaxBlockThreads = 1024;
constexpr int kMaxSharedBytes = 227 * 1024;

struct Box {
  float x1, y1, x2, y2, area;
};

// Corners of box slot b of one cell: ((tx+col)/S, (ty+row)/S, tw^2, th^2)
// -> (x -+ w/2, y -+ h/2); area = w*h from the decode, as the TPU kernel keeps it.
__device__ __forceinline__ Box decode_box(const float* cell, int C, int B, int b,
                                          int row, int col, float fS) {
  const float* raw = cell + C + B + 4 * b;
  const float x = __fdiv_rn(__fadd_rn(raw[0], (float)col), fS);
  const float y = __fdiv_rn(__fadd_rn(raw[1], (float)row), fS);
  const float w = __fmul_rn(raw[2], raw[2]);
  const float h = __fmul_rn(raw[3], raw[3]);
  const float hw = __fmul_rn(w, 0.5f);  // exact, equals w / 2
  const float hh = __fmul_rn(h, 0.5f);
  Box box;
  box.x1 = __fsub_rn(x, hw);
  box.y1 = __fsub_rn(y, hh);
  box.x2 = __fadd_rn(x, hw);
  box.y2 = __fadd_rn(y, hh);
  box.area = __fmul_rn(w, h);
  return box;
}

// Strict '>' sweep from class 0: the first maximum wins.
__device__ __forceinline__ int class_argmax(const float* cell, int C) {
  float best = cell[0];
  int cls = 0;
  for (int c = 1; c < C; ++c) {
    const float v = cell[c];
    if (v > best) {
      best = v;
      cls = c;
    }
  }
  return cls;
}

// Dense decode. One thread per (image, cell); a block stages its cells'
// channels through shared memory with a coalesced copy, then writes the
// cell's B slots at slot index cell*B + b.
__global__ void decode_grid_kernel(const float* __restrict__ net,
                                   float* __restrict__ boxes,
                                   float* __restrict__ scores,
                                   int* __restrict__ classes, int total_cells,
                                   int S, int B, int C, float thresh) {
  extern __shared__ float tile[];
  const int CC = C + 5 * B;
  const int first = blockIdx.x * blockDim.x;
  const int count = min((int)blockDim.x, total_cells - first);
  const float* src = net + (size_t)first * CC;
  for (int i = threadIdx.x; i < count * CC; i += blockDim.x) tile[i] = src[i];
  __syncthreads();
  if ((int)threadIdx.x >= count) return;

  const int g = first + threadIdx.x;  // global cell index, image-major
  const int cell_idx = g % (S * S);
  const float* cell = tile + threadIdx.x * CC;
  const int cls = class_argmax(cell, C);
  for (int b = 0; b < B; ++b) {
    const Box box = decode_box(cell, C, B, b, cell_idx / S, cell_idx % S, (float)S);
    const size_t slot = (size_t)g * B + b;
    reinterpret_cast<float4*>(boxes)[slot] = make_float4(box.x1, box.y1, box.x2, box.y2);
    const float conf = cell[C + b];
    scores[slot] = conf > thresh ? conf : 0.0f;
    classes[slot] = cls;
  }
}

// Decode + greedy NMS. One block per image; thread t owns the slots with
// key t, t + blockDim, ... (key = b*S*S + cell, the TPU kernel's order) and
// keeps their corners, area, score, class and alive flag in registers.
//
// Each of the K steps is one block-wide max of the packed 64-bit key
// (float bits of the score << 32) | (0xFFFFFFFF - key): alive scores are
// > 0, so their bit patterns order like the floats and the maximum is
// "highest score, then lowest key". The per-warp maxima go through a
// double-buffered shared array, so a step costs one __syncthreads. The
// picked box is read back from the decoded slots in shared memory.
// __launch_bounds__ caps registers at 64 a thread so that 1024 threads
// fit on an SM: without it the 4-slot variant does not launch.
template <int SPT>
__global__ void __launch_bounds__(kMaxBlockThreads)
    decode_nms_kernel(const float* __restrict__ net, float* __restrict__ out_boxes,
                      float* __restrict__ out_scores, int* __restrict__ out_classes,
                      int S, int B, int C, float thresh, float iou_thresh, int K,
                      int class_aware) {
  extern __shared__ unsigned long long smem[];
  const int SS = S * S, CC = C + 5 * B, n = SS * B;
  unsigned long long* warp_best = smem;  // 2 x 32
  float* grid = reinterpret_cast<float*>(smem + 64);
  float* sx1 = grid + SS * CC;
  float* sy1 = sx1 + n;
  float* sx2 = sy1 + n;
  float* sy2 = sx2 + n;
  int* scls = reinterpret_cast<int*>(sy2 + n);

  const int img = blockIdx.x;
  const float* src = net + (size_t)img * SS * CC;
  for (int i = threadIdx.x; i < SS * CC; i += blockDim.x) grid[i] = src[i];
  __syncthreads();

  float x1[SPT], y1[SPT], x2[SPT], y2[SPT], area[SPT], score[SPT];
  int cls[SPT];
  bool alive[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int key = threadIdx.x + j * blockDim.x;
    alive[j] = false;
    score[j] = 0.0f;
    x1[j] = y1[j] = x2[j] = y2[j] = area[j] = 0.0f;
    cls[j] = 0;
    if (key < n) {
      const int b = key / SS, cell_idx = key % SS;
      const float* cell = grid + cell_idx * CC;
      const Box box = decode_box(cell, C, B, b, cell_idx / S, cell_idx % S, (float)S);
      x1[j] = box.x1;
      y1[j] = box.y1;
      x2[j] = box.x2;
      y2[j] = box.y2;
      area[j] = box.area;
      cls[j] = class_argmax(cell, C);
      const float conf = cell[C + b];
      score[j] = conf > thresh ? conf : 0.0f;
      alive[j] = score[j] > 0.0f;
      sx1[key] = box.x1;
      sy1[key] = box.y1;
      sx2[key] = box.x2;
      sy2[key] = box.y2;
      scls[key] = cls[j];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* ob = out_boxes + (size_t)img * K * 4;
  float* os = out_scores + (size_t)img * K;
  int* oc = out_classes + (size_t)img * K;

  for (int k = 0; k < K; ++k) {
    unsigned long long best = 0;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (alive[j]) {
        const unsigned key = threadIdx.x + j * blockDim.x;
        const unsigned long long packed =
            ((unsigned long long)__float_as_uint(score[j]) << 32) | (0xFFFFFFFFu - key);
        best = packed > best ? packed : best;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      best = other > best ? other : best;
    }
    unsigned long long* buf = warp_best + (k & 1) * 32;
    if (lane == 0) buf[warp] = best;
    __syncthreads();
    best = 0;
    for (int w = 0; w < nwarps; ++w) best = buf[w] > best ? buf[w] : best;

    if (best == 0) {  // nothing alive: this and every later slot stays empty
      for (int i = k + threadIdx.x; i < K; i += blockDim.x) {
        os[i] = 0.0f;
        oc[i] = 0;
        reinterpret_cast<float4*>(ob)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      return;
    }
    const int pick = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFull));
    const float bx1 = sx1[pick], by1 = sy1[pick], bx2 = sx2[pick], by2 = sy2[pick];
    const int bcls = scls[pick];
    // the picked box's area comes from its corners, as in the TPU kernel
    const float barea = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
    if (threadIdx.x == 0) {
      os[k] = __uint_as_float((unsigned)(best >> 32));
      oc[k] = bcls;
      reinterpret_cast<float4*>(ob)[k] = make_float4(bx1, by1, bx2, by2);
    }

#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (!alive[j]) continue;
      const float iw = fmaxf(0.0f, __fsub_rn(fminf(x2[j], bx2), fmaxf(x1[j], bx1)));
      const float ih = fmaxf(0.0f, __fsub_rn(fminf(y2[j], by2), fmaxf(y1[j], by1)));
      const float inter = __fmul_rn(iw, ih);
      const float uni = fmaxf(__fsub_rn(__fadd_rn(area[j], barea), inter), 1e-10f);
      const float iou = fminf(fmaxf(__fdiv_rn(inter, uni), 0.0f), 1.0f);
      bool kill = iou > iou_thresh;
      if (class_aware) kill = kill && cls[j] == bcls;
      const int key = threadIdx.x + j * blockDim.x;
      if (kill || key == pick) alive[j] = false;
    }
  }
}

template <int SPT>
cudaError_t launch_nms(const float* net, float* boxes, float* scores, int* classes,
                       int batch, int S, int B, int C, float thresh, float iou_thresh,
                       int K, int class_aware, int threads, size_t smem,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_nms_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_nms_kernel<SPT><<<batch, threads, smem, stream>>>(
      net, boxes, scores, classes, S, B, C, thresh, iou_thresh, K, class_aware);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t tfy2_decode_grid(const float* net, float* boxes, float* scores,
                                        int* classes, int batch, int S, int B, int C,
                                        float thresh, cudaStream_t stream) {
  const int CC = C + 5 * B;
  const int total = batch * S * S;
  int threads = kDecodeThreads;
  while (threads > 32 && (size_t)threads * CC * sizeof(float) > 48 * 1024) threads -= 32;
  const size_t smem = (size_t)threads * CC * sizeof(float);
  if (batch <= 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  decode_grid_kernel<<<blocks, threads, smem, stream>>>(net, boxes, scores, classes,
                                                        total, S, B, C, thresh);
  return cudaGetLastError();
}

extern "C" cudaError_t tfy2_decode_nms(const float* net, float* boxes, float* scores,
                                       int* classes, int batch, int S, int B, int C,
                                       float thresh, float iou_thresh, int K,
                                       int class_aware, cudaStream_t stream) {
  const int CC = C + 5 * B, n = S * S * B;
  if (batch <= 0 || K <= 0 || n <= 0) return cudaErrorInvalidValue;
  const int whole_warps = (n + 31) / 32 * 32;
  const int threads = whole_warps < kMaxBlockThreads ? whole_warps : kMaxBlockThreads;
  const int spt = (n + threads - 1) / threads;
  const size_t smem = 64 * sizeof(unsigned long long) +
                      (size_t)S * S * CC * sizeof(float) + (size_t)n * 5 * sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  switch (spt) {
    case 1:
      return launch_nms<1>(net, boxes, scores, classes, batch, S, B, C, thresh,
                           iou_thresh, K, class_aware, threads, smem, stream);
    case 2:
      return launch_nms<2>(net, boxes, scores, classes, batch, S, B, C, thresh,
                           iou_thresh, K, class_aware, threads, smem, stream);
    case 3:
    case 4:
      return launch_nms<4>(net, boxes, scores, classes, batch, S, B, C, thresh,
                           iou_thresh, K, class_aware, threads, smem, stream);
    default:
      return cudaErrorInvalidValue;  // more than 4096 slots per image
  }
}
