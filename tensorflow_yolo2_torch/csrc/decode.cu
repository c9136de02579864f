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

#include <cstdint>

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kNmsMaxThreads = 512;  // two blocks an SM at <= 64 registers a thread
constexpr int kMaxSlots = 4096;      // slots an image that decode + NMS takes
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kChunkBytes = 48 * 1024;  // at most a chunk of the grid staged at once
constexpr int kBuckets = 256;           // of the sort by score
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// Dense decode (B3). One thread per (image, cell), a block's cells one
// contiguous run of the grid and of each output. The block stages its
// cells' channels in shared memory with 16-byte loads (every load of a
// thread issued before its first store), decodes its cell from there, and
// stages its slots' boxes, scores and classes in shared memory, so that
// each output leaves as one contiguous run of 16-byte stores. Reads and
// writes every byte once: the bytes bound it (at batch 256, S=14: 6.02 MB
// in, 2.41 MB out, 2.5 us at 3.35 TB/s).
//
// Measured at batch 256, S=14 (chip_smoke.py --decode-ab, H100 80GB HBM3,
// 700 W): a staging loop of 4-byte loads, a few in flight at a time, took
// 8.4 us; the 16-byte loads all in flight 4.5; the staged outputs 3.8.
// The threads read their cells at a 30-float stride, two-way bank
// conflicts in the class argmax: reading the classes in pairs, free of
// them, gained 0.04 us, so the cell is read one float at a time.
constexpr int kGridLoads = 8;  // 16-byte loads in flight a thread

// Shared memory of a block of `threads` cells: the staged grid, rounded to
// whole float4s, then the slots' boxes, scores and classes.
__host__ __device__ inline size_t grid_tile_floats(int threads, int CC) {
  return ((size_t)threads * CC + 3) / 4 * 4;
}
__host__ __device__ inline size_t grid_smem_bytes(int threads, int B, int C) {
  return (grid_tile_floats(threads, C + 5 * B) + (size_t)threads * B * 6) * sizeof(float);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0, n) = src[0, n), with 16-byte stores where both ends
// allow; T is float or int
template <typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ dst, const T* __restrict__ src, int n) {
  int done = 0;
  if (aligned16(dst)) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void decode_grid_kernel(const float* __restrict__ net,
                                   float* __restrict__ boxes,
                                   float* __restrict__ scores,
                                   int* __restrict__ classes, int total_cells,
                                   int S, int B, int C, float thresh) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int CC = C + 5 * B;
  const int threads = blockDim.x;
  const int first = blockIdx.x * threads;
  const int count = min(threads, total_cells - first);
  const int tid = threadIdx.x;

  // stage the block's count * CC channels; 16-byte loads where the run
  // starts 16-byte aligned (blocks of a multiple of 4 cells: wherever net
  // does)
  const float* src = net + (size_t)first * CC;
  const int n = count * CC;
  int staged = 0;
  if (aligned16(src)) {
    const int n4 = n / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int base = 0; base < n4; base += kGridLoads * threads) {
      float4 v[kGridLoads];
#pragma unroll
      for (int u = 0; u < kGridLoads; ++u) {
        const int i = base + u * threads + tid;
        if (i < n4) v[u] = __ldg(src4 + i);
      }
#pragma unroll
      for (int u = 0; u < kGridLoads; ++u) {
        const int i = base + u * threads + tid;
        if (i < n4) smem4[i] = v[u];
      }
    }
    staged = 4 * n4;
  }
  for (int i = staged + tid; i < n; i += threads) tile[i] = __ldg(src + i);
  __syncthreads();

  float4* sbox = smem4 + grid_tile_floats(threads, CC) / 4;
  float* sscore = reinterpret_cast<float*>(sbox + (size_t)threads * B);
  int* sclass = reinterpret_cast<int*>(sscore + (size_t)threads * B);
  if (tid < count) {
    const int g = first + tid;  // global cell index, image-major
    const int cell_idx = g % (S * S);
    const float* cell = tile + tid * CC;
    const int cls = class_argmax(cell, C);
    for (int b = 0; b < B; ++b) {
      const Box box = decode_box(cell, C, B, b, cell_idx / S, cell_idx % S, (float)S);
      const int slot = tid * B + b;
      sbox[slot] = make_float4(box.x1, box.y1, box.x2, box.y2);
      const float conf = cell[C + b];
      sscore[slot] = conf > thresh ? conf : 0.0f;
      sclass[slot] = cls;
    }
  }
  __syncthreads();

  // the block's slots first * B ... are contiguous in each output
  const size_t out0 = (size_t)first * B;
  copy_out(boxes + 4 * out0, reinterpret_cast<const float*>(sbox), 4 * count * B);
  copy_out(scores + out0, sscore, count * B);
  copy_out(classes + out0, sclass, count * B);
}

// One decoded slot: corners and area, thresholded score, class. The box
// and class are set only for a score > 0: no other slot takes part in NMS.
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
// slots. cell points at the channels of cell cell_idx.
struct GridDecode {
  __host__ __device__ static int channels(int B, int C) { return C + 5 * B; }
  __device__ static Slot slot(const float* cell, const DecodeArgs& a, int b, int cell_idx) {
    Slot s;
    const float conf = cell[a.C + b];
    s.score = conf > a.thresh ? conf : 0.0f;
    if (s.score > 0.0f) {
      s.box = decode_box(cell, a.C, a.B, b, cell_idx / a.S, cell_idx % a.S, (float)a.S);
      s.cls = class_argmax(cell, a.C);
    }
    return s;
  }
};

// Anchor decode (_decode_nms_v2_kernel): sigmoid xy + offsets,
// (anchor * exp(clip(t, -8, 8))) / S wh, per-slot argmax, score
// sigmoid(conf) / sum_c exp(l_c - l_max) summed from c = 0. The sum holds
// exp(0) = 1 and rounds up from there, so the score is at most
// sigmoid(conf): a slot whose sigmoid(conf) is not above the threshold
// scores 0 whatever its logits, and is not decoded further.
struct AnchorDecode {
  __host__ __device__ static int channels(int B, int C) { return B * (5 + C); }
  __device__ static Slot slot(const float* cell, const DecodeArgs& a, int b, int cell_idx) {
    const float* raw = cell + b * (5 + a.C);
    Slot s;
    s.score = 0.0f;
    const float obj = sigmoid(raw[4]);
    if (!(obj > a.thresh && obj > 0.0f)) return s;
    const float* logits = raw + 5;
    s.cls = class_argmax(logits, a.C);
    const float best = logits[s.cls];
    float denom = 0.0f;
    for (int c = 0; c < a.C; ++c) denom = __fadd_rn(denom, expf(__fsub_rn(logits[c], best)));
    const float score = __fdiv_rn(obj, denom);
    s.score = score > a.thresh ? score : 0.0f;
    if (s.score > 0.0f) {
      const float fS = (float)a.S;
      const float tw = fminf(fmaxf(raw[2], -8.0f), 8.0f);
      const float th = fminf(fmaxf(raw[3], -8.0f), 8.0f);
      s.box = corners(__fdiv_rn(__fadd_rn(sigmoid(raw[0]), (float)(cell_idx % a.S)), fS),
                      __fdiv_rn(__fadd_rn(sigmoid(raw[1]), (float)(cell_idx / a.S)), fS),
                      __fdiv_rn(__fmul_rn(a.anchors[2 * b], expf(tw)), fS),
                      __fdiv_rn(__fmul_rn(a.anchors[2 * b + 1], expf(th)), fS));
    }
    return s;
  }
};

// A box as the NMS sees it: corners, the decode's w*h (its area as a
// candidate), the area from its corners (its area as the picked box), class.
struct Cand {
  float x1, y1, x2, y2, area, carea;
  int cls;
};

// Whether the picked box p suppresses the candidate c: the TPU sweep's
// IoU, bit for bit, and its class rule. Two shortcuts give the same
// answer: a class mismatch under class_aware, and inter == 0, where
// 0 / max(uni, 1e-10) is 0 for every uni, so the IoU exceeds only a
// negative threshold.
__device__ __forceinline__ bool suppresses(const Cand& p, const Cand& c, float iou_thresh,
                                           int class_aware) {
  if (class_aware && c.cls != p.cls) return false;
  const float iw = fmaxf(0.0f, __fsub_rn(fminf(c.x2, p.x2), fmaxf(c.x1, p.x1)));
  const float ih = fmaxf(0.0f, __fsub_rn(fminf(c.y2, p.y2), fmaxf(c.y1, p.y1)));
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f > iou_thresh;
  const float uni = fmaxf(__fsub_rn(__fadd_rn(c.area, p.carea), inter), 1e-10f);
  return fminf(fmaxf(__fdiv_rn(inter, uni), 0.0f), 1.0f) > iou_thresh;
}

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int src) {
  Cand o;
  o.x1 = __shfl_sync(kFull, c.x1, src);
  o.y1 = __shfl_sync(kFull, c.y1, src);
  o.x2 = __shfl_sync(kFull, c.x2, src);
  o.y2 = __shfl_sync(kFull, c.y2, src);
  o.area = __shfl_sync(kFull, c.area, src);
  o.carea = __shfl_sync(kFull, c.carea, src);
  o.cls = __shfl_sync(kFull, c.cls, src);
  return o;
}

// Copies from global to shared memory that run while the block computes
// (cp.async, 4 or 16 bytes), waited for a committed group at a time.
template <int Bytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Floats of a buffer that stages chunk_cells cells of CC channels: up to
// 3 floats of alignment shift before them, rounded up to 16 bytes.
__host__ __device__ inline int chunk_floats(int chunk_cells, int CC) {
  return (chunk_cells * CC + 6) & ~3;
}

// Shared memory of decode_nms_kernel, in bytes from its start: a region
// that holds the two chunk buffers during the decode, then the sort's
// scattered keys and buckets, then the picks; the list of keys; the
// decoded slots by key; a few words.
struct NmsSmem {
  size_t keys, slots, words, total;
  __host__ __device__ NmsSmem(int n, int buffer_floats) {
    const size_t sort = 8 * (size_t)n + 2 * kBuckets * sizeof(int);
    const size_t region = 8 * (size_t)buffer_floats > sort ? 8 * (size_t)buffer_floats : sort;
    keys = (region + 15) & ~(size_t)15;
    slots = keys + 8 * (size_t)n;
    words = slots + 24 * (size_t)n;
    total = words + 5 * 32 * sizeof(int) + 16;
  }
};

// Decode + greedy NMS for either decode, one block per image.
//
// 1. The image's grid is staged in shared memory a chunk of chunk_cells
//    cells at a time, by asynchronous 16-byte copies on neighbouring
//    addresses into two buffers: the block decodes a chunk while the next
//    one arrives.
// 2. The block's threads decode a chunk's slots (key = b*S*S + cell, the
//    TPU kernel's order), neighbouring threads on neighbouring cells. An
//    alive slot (score > 0) keeps its box by key and appends its packed
//    key (float bits of the score << 32) | (0xFFFFFFFF - key) to a list.
//    Alive scores are > 0, so the packed keys order like "highest score,
//    then lowest key", the order in which the TPU sweep picks, and they
//    are unique.
// 3. The list is sorted once, highest first, by buckets of the score's
//    bits: a histogram of 256 buckets between the highest and lowest
//    score, a prefix sum, a scatter, and each key ranked by counting the
//    larger keys of its own bucket (a few, unless many scores are equal).
// 4. The greedy scan walks the sorted list in chunks of 32. A candidate is
//    picked when no earlier pick suppresses it. For a chunk, every warp
//    tests chunk members against the picks so far and against the members
//    before them (one test a lane, the results as ballots); then every warp
//    resolves the chunk from those bits alone: a member is picked once all
//    members before it that could suppress it are decided and none was
//    picked. Two block barriers a chunk, none a pick; the scan stops at K
//    picks or at the end of the list, which is the TPU sweep's result: its
//    next pick is always the highest alive key.
//
// The scan's work is the candidates it visits times the picks before
// them, not K times all slots. What bounds the kernel: the grid's bytes
// (staging), then the scan's chunks, two barriers each, of the image that
// visits the most candidates before its K-th pick.
template <class Decode>
__global__ void __launch_bounds__(kNmsMaxThreads, 2)
    decode_nms_kernel(DecodeArgs a, float* __restrict__ out_boxes,
                      float* __restrict__ out_scores, int* __restrict__ out_classes,
                      float iou_thresh, int K, int class_aware, int chunk_cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SS = a.S * a.S, CC = Decode::channels(a.B, a.C), n = SS * a.B;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int buffer_floats = chunk_floats(chunk_cells, CC);
  const NmsSmem lay(n, buffer_floats);
  unsigned long long* region = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  float* fx1 = reinterpret_cast<float*>(smem + lay.slots);
  float* fy1 = fx1 + n;
  float* fx2 = fy1 + n;
  float* fy2 = fx2 + n;
  float* farea = fy2 + n;
  int* fcls = reinterpret_cast<int*>(farea + n);
  unsigned* smask = reinterpret_cast<unsigned*>(smem + lay.words);  // 32
  int* sdead = reinterpret_cast<int*>(smask + 32);                   // 32
  unsigned* wmax = reinterpret_cast<unsigned*>(sdead + 32);          // 32
  unsigned* wmin = wmax + 32;                                        // 32
  int* scount = reinterpret_cast<int*>(wmin + 32);

  const int img = blockIdx.x;
  const float* grid = a.net + (size_t)img * SS * CC;
  if (tid == 0) *scount = 0;

  // chunk ch: cells [ch * chunk_cells, ...) into buffer ch % 2, at the
  // same offset mod 16 bytes as in global memory
  const int nchunks = (SS + chunk_cells - 1) / chunk_cells;
  const auto shift = [&](int ch) {
    return (int)((reinterpret_cast<size_t>(grid + (size_t)ch * chunk_cells * CC) >> 2) & 3);
  };
  const auto buffer = [&](int ch) {
    return reinterpret_cast<float*>(smem) + (ch & 1) * buffer_floats + shift(ch);
  };
  const auto stage = [&](int ch) {
    const float* src = grid + (size_t)ch * chunk_cells * CC;
    float* dst = buffer(ch);
    const int count = (min(SS, (ch + 1) * chunk_cells) - ch * chunk_cells) * CC;
    const int head = min((4 - shift(ch)) & 3, count);
    const int nvec = (count - head) >> 2;
    for (int q = tid; q < nvec; q += T) copy_async<16>(dst + head + 4 * q, src + head + 4 * q);
    if (tid < head) copy_async<4>(dst + tid, src + tid);
    if (head + 4 * nvec + tid < count)
      copy_async<4>(dst + head + 4 * nvec + tid, src + head + 4 * nvec + tid);
    copy_commit();
  };

  // decode; alive slots append their packed keys, a warp at a time
  stage(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage(ch + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const int c0 = ch * chunk_cells, cells = min(SS - c0, chunk_cells);
    const float* chunk = buffer(ch);
    for (int base = 0; base < a.B * cells; base += T) {
      const int i = base + tid;
      unsigned long long packed = 0;
      if (i < a.B * cells) {
        const int b = i / cells, cell = c0 + i % cells, key = b * SS + cell;
        const Slot s = Decode::slot(chunk + (cell - c0) * CC, a, b, cell);
        if (s.score > 0.0f) {
          fx1[key] = s.box.x1;
          fy1[key] = s.box.y1;
          fx2[key] = s.box.x2;
          fy2[key] = s.box.y2;
          farea[key] = s.box.area;
          fcls[key] = s.cls;
          packed = ((unsigned long long)__float_as_uint(s.score) << 32) | (0xFFFFFFFFu - key);
        }
      }
      const unsigned alive = __ballot_sync(kFull, packed != 0);
      int at = 0;
      if (lane == 0 && alive != 0) at = atomicAdd(scount, __popc(alive));
      at = __shfl_sync(kFull, at, 0);
      if (packed != 0) keys[at + __popc(alive & ((1u << lane) - 1))] = packed;
    }
    __syncthreads();  // the buffer is staged into again two chunks on
  }
  const int m = *scount;

  // sort, highest key first; the chunk buffers are no longer read
  unsigned long long* spread = region;  // the keys, bucket by bucket
  int* first = reinterpret_cast<int*>(region + n);  // each bucket's first position
  int* next = first + kBuckets;                      // counts, then fill cursors
  unsigned hi = 0, lo = 0xFFFFFFFFu;  // the scores' bits
  for (int p = tid; p < m; p += T) {
    const unsigned bits = (unsigned)(keys[p] >> 32);
    hi = max(hi, bits);
    lo = min(lo, bits);
  }
  hi = __reduce_max_sync(kFull, hi);
  lo = __reduce_min_sync(kFull, lo);
  if (lane == 0) {
    wmax[warp] = hi;
    wmin[warp] = lo;
  }
  for (int b = tid; b < kBuckets; b += T) next[b] = 0;
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    hi = max(hi, wmax[w]);
    lo = min(lo, wmin[w]);
  }
  // bucket 0 holds the highest scores; the span of the bits fits 8 bits
  const unsigned span = hi - lo;
  const int drop = span < kBuckets ? 0 : 24 - __clz(span);
  const auto bucket = [&](unsigned long long key) {
    return (int)((hi - (unsigned)(key >> 32)) >> drop);
  };
  for (int p = tid; p < m; p += T) atomicAdd(&next[bucket(keys[p])], 1);
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sum of the counts, 8 buckets a lane
    constexpr int kEach = kBuckets / 32;
    int count[kEach], sum = 0;
#pragma unroll
    for (int i = 0; i < kEach; ++i) sum += count[i] = next[kEach * lane + i];
    int before = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, before, d);
      if (lane >= d) before += v;
    }
    before -= sum;
#pragma unroll
    for (int i = 0; i < kEach; ++i) {
      first[kEach * lane + i] = next[kEach * lane + i] = before;
      before += count[i];
    }
  }
  __syncthreads();
  for (int p = tid; p < m; p += T) {
    const unsigned long long key = keys[p];
    spread[atomicAdd(&next[bucket(key)], 1)] = key;
  }
  __syncthreads();
  for (int p = tid; p < m; p += T) {  // rank within the bucket
    const unsigned long long key = spread[p];
    const int b = bucket(key), end = next[b];
    int at = first[b];
    for (int q = first[b]; q < end; ++q) at += spread[q] > key;
    keys[at] = key;
  }
  __syncthreads();
  const unsigned long long* sorted = keys;
  int* picks = reinterpret_cast<int*>(region);  // the slots picked, in order

  float* ob = out_boxes + (size_t)img * K * 4;
  float* os = out_scores + (size_t)img * K;
  int* oc = out_classes + (size_t)img * K;
  // the decoded slot s as a candidate
  const auto load = [&](int s) {
    return Cand{fx1[s], fy1[s], fx2[s], fy2[s], farea[s],
                __fmul_rn(__fsub_rn(fx2[s], fx1[s]), __fsub_rn(fy2[s], fy1[s])), fcls[s]};
  };
  int npicks = 0;
  for (int t = 0; t < m && npicks < K; t += 32) {
    const int c = min(32, m - t);
    // lane l holds chunk member l
    Cand mine{};
    unsigned long long mkey = 0;
    if (lane < c) {
      mkey = sorted[t + lane];
      mine = load((int)(0xFFFFFFFFu - (unsigned)mkey));
    }
    // tests, a member j a warp at a time: lane l tests whether member l
    // (for l < j) and picks l, l + 32, ... suppress member j
    Cand pick{};
    if (lane < npicks) pick = load(picks[lane]);
    for (int j = warp; j < c; j += nwarps) {
      const Cand cj = shfl_cand(mine, j);
      const bool by_member = lane < j && suppresses(mine, cj, iou_thresh, class_aware);
      bool by_pick = lane < npicks && suppresses(pick, cj, iou_thresh, class_aware);
      for (int i = lane + 32; i < npicks && !by_pick; i += 32)
        by_pick = suppresses(load(picks[i]), cj, iou_thresh, class_aware);
      const unsigned mask = __ballot_sync(kFull, by_member);
      const bool dead = __any_sync(kFull, by_pick);
      if (lane == 0) {
        smask[j] = mask;
        sdead[j] = dead;
      }
    }
    __syncthreads();
    // every warp resolves the chunk from the bits
    const unsigned before = lane < c ? smask[lane] : 0u;
    unsigned picked = 0;
    unsigned decided = __ballot_sync(kFull, lane >= c || sdead[lane]);
    while (~(picked | decided) != 0) {
      const unsigned open = ~(picked | decided);
      const bool mine_open = (open >> lane) & 1u;
      const bool take = mine_open && (before & (picked | open)) == 0;
      const bool drop = mine_open && (before & picked) != 0;
      picked |= __ballot_sync(kFull, take);
      decided |= __ballot_sync(kFull, drop);
    }
    if (__popc(picked) > K - npicks) {  // the first K - npicks picks only
      unsigned first = 0;
      for (int i = npicks; i < K; ++i) {
        first |= picked & (0u - picked);
        picked &= picked - 1;
      }
      picked = first;
    }
    if (warp == 0 && ((picked >> lane) & 1u)) {
      const int k = npicks + __popc(picked & ((1u << lane) - 1));
      os[k] = __uint_as_float((unsigned)(mkey >> 32));
      oc[k] = mine.cls;
      reinterpret_cast<float4*>(ob)[k] = make_float4(mine.x1, mine.y1, mine.x2, mine.y2);
      picks[k] = (int)(0xFFFFFFFFu - (unsigned)mkey);
    }
    npicks += __popc(picked);
    __syncthreads();
  }
  for (int k = npicks + tid; k < K; k += T) {  // empty slots: zeros
    os[k] = 0.0f;
    oc[k] = 0;
    reinterpret_cast<float4*>(ob)[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Threads, shared memory and chunks for one image: the grid is staged in
// at least two chunks of at most kChunkBytes, so that loads and decode
// overlap (two of 85 cells at 416², B = 5). threads = 0 for an empty
// problem, more than 4096 slots an image, or more shared memory than a
// block may have.
struct NmsGeometry {
  int threads, chunk_cells;
  size_t smem;
};

template <class Decode>
NmsGeometry nms_geometry(int S, int B, int C) {
  const int SS = S * S, n = SS * B, CC = Decode::channels(B, C);
  if (n <= 0 || n > kMaxSlots) return {0, 0, 0};
  const int passes = (n + kNmsMaxThreads - 1) / kNmsMaxThreads;
  const size_t bytes = 4 * (size_t)SS * CC;
  const int chunks = max(2, (int)((bytes + kChunkBytes - 1) / kChunkBytes));
  NmsGeometry g{((n + passes - 1) / passes + 31) / 32 * 32, (SS + chunks - 1) / chunks, 0};
  g.smem = NmsSmem(n, chunk_floats(g.chunk_cells, CC)).total;
  if (g.smem > kMaxSharedBytes) g.threads = 0;
  return g;
}

template <class Decode>
cudaError_t allow_smem(const NmsGeometry& g) {
  if (g.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(decode_nms_kernel<Decode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
}

// The launch; cudaErrorInvalidValue where nms_geometry has no threads.
template <class Decode>
cudaError_t decode_nms(const DecodeArgs& a, float* boxes, float* scores, int* classes,
                       int batch, float iou_thresh, int K, int class_aware,
                       cudaStream_t stream) {
  const NmsGeometry g = nms_geometry<Decode>(a.S, a.B, a.C);
  if (batch <= 0 || K <= 0 || g.threads == 0) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<Decode>(g);
  if (err != cudaSuccess) return err;
  decode_nms_kernel<Decode><<<batch, g.threads, g.smem, stream>>>(
      a, boxes, scores, classes, iou_thresh, K, class_aware, g.chunk_cells);
  return cudaGetLastError();
}

// out = {threads a block, shared memory bytes, chunks the grid is staged
// in, blocks an SM holds by the occupancy calculator}.
template <class Decode>
cudaError_t nms_occupancy(int S, int B, int C, int* out) {
  const NmsGeometry g = nms_geometry<Decode>(S, B, C);
  if (g.threads == 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<Decode>(g);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], decode_nms_kernel<Decode>,
                                                        g.threads, g.smem);
  out[0] = g.threads;
  out[1] = (int)g.smem;
  out[2] = (S * S + g.chunk_cells - 1) / g.chunk_cells;
  return err;
}

}  // namespace

extern "C" cudaError_t tfy2_decode_grid(const float* net, float* boxes, float* scores,
                                        int* classes, int batch, int S, int B, int C,
                                        float thresh, cudaStream_t stream) {
  const int total = batch * S * S;
  // a multiple of 4 cells a block (16-byte aligned runs), within 48 KB
  int threads = kDecodeThreads;
  while (threads > 32 && grid_smem_bytes(threads, B, C) > 48 * 1024) threads -= 32;
  const size_t smem = grid_smem_bytes(threads, B, C);
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

// The launch geometry of tfy2_decode_nms (v2 = 0) or tfy2_decode_nms_v2
// (v2 = 1) for an S x S x B grid of C classes: out[4] as nms_occupancy.
extern "C" cudaError_t tfy2_decode_nms_occupancy(int S, int B, int C, int v2, int* out) {
  return v2 ? nms_occupancy<AnchorDecode>(S, B, C, out) : nms_occupancy<GridDecode>(S, B, C, out);
}
