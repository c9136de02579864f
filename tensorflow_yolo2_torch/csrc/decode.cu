// YOLO grid decode and decode + greedy NMS, written for Hopper (sm_90a).
//
// Replaces the three decode kernels of tensorflow_yolo2_tpu/ops/pallas_decode.py:
//   tfy2_decode_grid    <- decode_grid_pallas / _decode_kernel (v1)
//   tfy2_decode_nms     <- decode_nms_pallas / _decode_nms_kernel + _nms_sweep (v1)
//   tfy2_decode_nms_v2  <- decode_nms_pallas / _decode_nms_v2_kernel + _nms_sweep
//                          (YOLOv2 anchor head, per-slot classes)
//
// Input is the head's NHWC grid, (N, S, S, CC) float32, contiguous. A v1
// cell is [C class scores | B confidences | B * (x, y, w, h)], CC = C + 5B;
// an anchor cell is B slots of (x, y, w, h, conf, C class logits),
// CC = B * (5 + C). The TPU kernels transpose the grid to channels-major
// rows for the lane layout; here a thread owns a cell (or a slot) and
// reads its channels itself.
//
// Every arithmetic step uses the round-to-nearest intrinsics so that nvcc
// contracts nothing into an FMA and each division is the IEEE quotient,
// and exp is the CUDA library's expf, which torch.exp's kernel also calls:
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

// Corners of the box (x, y, w, h): (x -+ w/2, y -+ h/2); area = w*h from
// the decode, as the TPU kernels keep it.
__device__ __forceinline__ Box corners(float x, float y, float w, float h) {
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

// v1 box slot b of one cell: ((tx+col)/S, (ty+row)/S, tw^2, th^2).
__device__ __forceinline__ Box decode_box(const float* cell, int C, int B, int b,
                                          int row, int col, float fS) {
  const float* raw = cell + C + B + 4 * b;
  return corners(__fdiv_rn(__fadd_rn(raw[0], (float)col), fS),
                 __fdiv_rn(__fadd_rn(raw[1], (float)row), fS),
                 __fmul_rn(raw[2], raw[2]), __fmul_rn(raw[3], raw[3]));
}

// 1 / (1 + exp(-x)), as ops.boxes.sigmoid writes it.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// Maximum of v over the warp, in every lane.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = other > v ? other : v;
  }
  return v;
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

// One decoded slot: corners and area, thresholded score, class.
struct Slot {
  Box box;
  float score;
  int cls;
};

struct DecodeArgs {
  const float* net;      // (N, S, S, CC)
  const float* anchors;  // (B, 2) float32 priors in cell units; anchor head only
  int S, B, C;
  float thresh;
};

// v1 decode: bare-confidence threshold, one argmax per cell for its B
// slots. The B slots of a cell read the same class scores, so the image's
// grid is staged in shared memory first.
struct GridDecode {
  static constexpr bool kStage = true;
  __host__ __device__ static int channels(int B, int C) { return C + 5 * B; }
  __device__ static Slot slot(const float* grid, const DecodeArgs& a, int b,
                              int cell_idx) {
    const float* cell = grid + cell_idx * channels(a.B, a.C);
    Slot s;
    s.box = decode_box(cell, a.C, a.B, b, cell_idx / a.S, cell_idx % a.S, (float)a.S);
    s.cls = class_argmax(cell, a.C);
    const float conf = cell[a.C + b];
    s.score = conf > a.thresh ? conf : 0.0f;
    return s;
  }
};

// Anchor decode (_decode_nms_v2_kernel): sigmoid xy + offsets,
// (anchor * exp(clip(t, -8, 8))) / S wh, per-slot argmax, score
// sigmoid(conf) / sum_c exp(l_c - l_max) summed from c = 0. Each slot owns
// its 5 + C channels, so a thread reads them from global memory itself
// and shared memory holds only the decoded slots: every grid of at most
// 4096 slots runs (S <= 28 at B = 5; 608² is S = 19).
struct AnchorDecode {
  static constexpr bool kStage = false;
  __host__ __device__ static int channels(int B, int C) { return B * (5 + C); }
  __device__ static Slot slot(const float* grid, const DecodeArgs& a, int b,
                              int cell_idx) {
    const float* raw = grid + (size_t)cell_idx * channels(a.B, a.C) + b * (5 + a.C);
    const float fS = (float)a.S;
    const float tw = fminf(fmaxf(raw[2], -8.0f), 8.0f);
    const float th = fminf(fmaxf(raw[3], -8.0f), 8.0f);
    Slot s;
    s.box = corners(__fdiv_rn(__fadd_rn(sigmoid(raw[0]), (float)(cell_idx % a.S)), fS),
                    __fdiv_rn(__fadd_rn(sigmoid(raw[1]), (float)(cell_idx / a.S)), fS),
                    __fdiv_rn(__fmul_rn(a.anchors[2 * b], expf(tw)), fS),
                    __fdiv_rn(__fmul_rn(a.anchors[2 * b + 1], expf(th)), fS));
    const float* logits = raw + 5;
    s.cls = class_argmax(logits, a.C);
    const float best = logits[s.cls];
    float denom = 0.0f;
    for (int c = 0; c < a.C; ++c) denom = __fadd_rn(denom, expf(__fsub_rn(logits[c], best)));
    const float score = __fdiv_rn(sigmoid(raw[4]), denom);
    s.score = score > a.thresh ? score : 0.0f;
    return s;
  }
};

// Decode + greedy NMS, for either decode. One block per image; thread t
// owns the slots with key t, t + blockDim, ... (key = b*S*S + cell, the TPU
// kernel's order) and keeps their corners, area, score, class and alive
// flag in registers.
//
// Each of the K steps is one block-wide max of the packed 64-bit key
// (float bits of the score << 32) | (0xFFFFFFFF - key): alive scores are
// > 0, so their bit patterns order like the floats and the maximum is
// "highest score, then lowest key". The per-warp maxima go through a
// double-buffered shared array, so a step costs one __syncthreads, and
// each warp reduces them with shuffles rather than every thread reading
// all of them in turn.
// The picked box is read back from the decoded slots in shared memory.
// The sweep, not the decode or the bytes, bounds the kernel.
// __launch_bounds__ caps registers at 64 a thread so that 1024 threads
// fit on an SM: without it the 4-slot variant does not launch.
template <class Decode, int SPT>
__global__ void __launch_bounds__(kMaxBlockThreads)
    decode_nms_kernel(DecodeArgs a, float* __restrict__ out_boxes,
                      float* __restrict__ out_scores, int* __restrict__ out_classes,
                      float iou_thresh, int K, int class_aware) {
  extern __shared__ unsigned long long smem[];
  const int SS = a.S * a.S, CC = Decode::channels(a.B, a.C), n = SS * a.B;
  unsigned long long* warp_best = smem;  // 2 x 32
  float* staged = reinterpret_cast<float*>(smem + 64);
  float* sx1 = staged + (Decode::kStage ? SS * CC : 0);
  float* sy1 = sx1 + n;
  float* sx2 = sy1 + n;
  float* sy2 = sx2 + n;
  int* scls = reinterpret_cast<int*>(sy2 + n);

  const int img = blockIdx.x;
  const float* grid = a.net + (size_t)img * SS * CC;
  if (Decode::kStage) {
    for (int i = threadIdx.x; i < SS * CC; i += blockDim.x) staged[i] = grid[i];
    grid = staged;
    __syncthreads();
  }

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
      const Slot s = Decode::slot(grid, a, key / SS, key % SS);
      x1[j] = s.box.x1;
      y1[j] = s.box.y1;
      x2[j] = s.box.x2;
      y2[j] = s.box.y2;
      area[j] = s.box.area;
      cls[j] = s.cls;
      score[j] = s.score;
      alive[j] = s.score > 0.0f;
      sx1[key] = s.box.x1;
      sy1[key] = s.box.y1;
      sx2[key] = s.box.x2;
      sy2[key] = s.box.y2;
      scls[key] = s.cls;
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
    best = warp_max(best);
    unsigned long long* buf = warp_best + (k & 1) * 32;
    if (lane == 0) buf[warp] = best;
    __syncthreads();
    best = warp_max(lane < nwarps ? buf[lane] : 0ull);

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

template <class Decode, int SPT>
cudaError_t launch_nms(const DecodeArgs& a, float* boxes, float* scores, int* classes,
                       int batch, float iou_thresh, int K, int class_aware, int threads,
                       size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_nms_kernel<Decode, SPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_nms_kernel<Decode, SPT><<<batch, threads, smem, stream>>>(
      a, boxes, scores, classes, iou_thresh, K, class_aware);
  return cudaGetLastError();
}

// Block size, slots a thread and shared memory for one image, then the
// launch. cudaErrorInvalidValue for an empty problem, more than 4096 slots
// an image, or more shared memory than a block may have.
template <class Decode>
cudaError_t decode_nms(const DecodeArgs& a, float* boxes, float* scores, int* classes,
                       int batch, float iou_thresh, int K, int class_aware,
                       cudaStream_t stream) {
  const int SS = a.S * a.S, n = SS * a.B;
  if (batch <= 0 || K <= 0 || n <= 0) return cudaErrorInvalidValue;
  const int whole_warps = (n + 31) / 32 * 32;
  const int threads = whole_warps < kMaxBlockThreads ? whole_warps : kMaxBlockThreads;
  const int spt = (n + threads - 1) / threads;
  const size_t staged = Decode::kStage ? (size_t)SS * Decode::channels(a.B, a.C) : 0;
  const size_t smem =
      64 * sizeof(unsigned long long) + (staged + (size_t)n * 5) * sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  switch (spt) {
    case 1:
      return launch_nms<Decode, 1>(a, boxes, scores, classes, batch, iou_thresh, K,
                                   class_aware, threads, smem, stream);
    case 2:
      return launch_nms<Decode, 2>(a, boxes, scores, classes, batch, iou_thresh, K,
                                   class_aware, threads, smem, stream);
    case 3:
    case 4:
      return launch_nms<Decode, 4>(a, boxes, scores, classes, batch, iou_thresh, K,
                                   class_aware, threads, smem, stream);
    default:
      return cudaErrorInvalidValue;  // more than 4096 slots per image
  }
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
  const DecodeArgs a{net, nullptr, S, B, C, thresh};
  return decode_nms<GridDecode>(a, boxes, scores, classes, batch, iou_thresh, K,
                                class_aware, stream);
}

// anchors: (B, 2) float32 on the device, (w, h) in cell units.
extern "C" cudaError_t tfy2_decode_nms_v2(const float* net, const float* anchors,
                                          float* boxes, float* scores, int* classes,
                                          int batch, int S, int B, int C, float thresh,
                                          float iou_thresh, int K, int class_aware,
                                          cudaStream_t stream) {
  const DecodeArgs a{net, anchors, S, B, C, thresh};
  return decode_nms<AnchorDecode>(a, boxes, scores, classes, batch, iou_thresh, K,
                                  class_aware, stream);
}
