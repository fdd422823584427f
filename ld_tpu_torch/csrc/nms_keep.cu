// Greedy-NMS keep mask over score-sorted boxes, batched over images.
//
// Replaces the Pallas TPU kernel `_nms_fixpoint_kernel`
// (ld_tpu/ops/pallas_nms.py:23, launched by `pallas_nms_keep` :64-95). That
// kernel builds the strict-upper-triangular IoU > thr matrix in VMEM and
// iterates `keep <- valid & !(keep . S > 0.5)` on the MXU until it stops
// changing. The fixpoint is exactly greedy NMS, so this port computes greedy
// NMS directly instead of carrying the matrix iteration over. Boxes come in
// blocks of 64, one 64-bit word of bits per block; W = ceil(K / 64).
//
//   1. nms_mask_tri_kernel: one 256-thread CTA per upper-triangle tile
//      (row block r <= column block c), W(W+1)/2 tiles per image, spread
//      over the card. Row i = 64r + t gets one word whose bit u is set when
//      j = 64c + u > i and IoU(i, j) > thr; four threads share the row, 16
//      columns each, and their bits are ORed in shared memory. The tiles are
//      stored block-major, [b][r][c - r][t], so 64 threads store 64
//      neighbouring words and row block r's words for columns r..W-1 form one
//      contiguous run of (W - r) * 512 bytes.
//   2. nms_block_sweep_kernel: one CTA per image walks the row blocks in
//      order. A `removed` bit vector of W words in shared memory is seeded
//      with the invalid boxes and the tail past K. For block c:
//        a. the first kWindow tiles of its run (all of it while K <= 2048)
//           were copied into shared memory (cp.async) while block c-1 was
//           resolved, and the copy of block c+1's window is issued now, into
//           the other buffer of a ring of two;
//        b. one warp resolves the block from removed[c] with the 64 diagonal
//           words in registers: box t, if not yet removed, is kept and ORs
//           its diagonal word in. 64 steps of register ALU work;
//        c. the kept bits are propagated: one warp per later word w, the
//           lanes over the 64 rows, removed[w] |= OR of the kept rows' words
//           (__reduce_or_sync on the two halves). Words inside the window
//           come from shared memory, words past it from global memory, 512
//           coalesced bytes per warp.
//      Invalid boxes are never kept and so never suppress, as in the JAX
//      fixpoint, where keep starts at `valid`. At the end
//      keep[j] = !removed[j].
//
// What bounds it on an H100: not bytes (18 B per box in, 1 B out) and not
// operations (~14 float ops per pair, K^2/2 pairs: 7.3 MFLOP at K = 1024,
// about 0.1 us at the 67 TFLOP/s float32 rate), but the dependent chain of
// greedy NMS. The design shortens that chain from K steps, each waiting on an
// L2 read of a kept box's mask row, to K/64 block steps that read only
// shared memory and registers: per block, a 64-step register walk and two
// block-wide barriers. The mask rows reach shared memory one block ahead of
// the chain, so no L2 round trip is on it, and the time depends only weakly
// on how many boxes are kept. Past the window (K > 2048) the later words'
// reads go to L2, but they are independent of each other and of the walk:
// one round trip per block, not per kept box. Shared memory per image is two
// stage buffers of 512 * min(W, kWindow) bytes plus W words: 16.1 KiB at
// K = 1024, 34.1 KiB at K = 16800, so any K whose scratch fits on the card
// launches.
//
// IoU is computed bit for bit as the plain version computes it (the JAX
// `bbox_overlaps` order): area = (x2-x1)*(y2-y1), inter = clamp(w,0) *
// clamp(h,0), union = max(a_i + a_j - inter, 1e-6), iou = inter / union, with
// the round-to-nearest intrinsics and the file compiled with --fmad=false, so
// no product is fused into an add. A comparison that flips at the threshold
// would change the keep set.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;            // boxes per block, bits per word
constexpr int kMaskSplit = 4;        // mask-kernel threads per row
constexpr int kWindow = 32;          // tiles of a run staged in shared memory
constexpr int kSweepThreads = 256;   // 8 warps
constexpr int kSweepWarps = kSweepThreads / 32;

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__device__ __forceinline__ bool iou_above(const Box& a, const Box& b,
                                          float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(a.area, b.area), inter), 1e-6f);
  return __fdiv_rn(inter, uni) > thr;
}

// Upper-triangle tiles in row blocks 0..r-1: the start of row block r's run,
// in tiles.
__host__ __device__ __forceinline__ int tiles_before(int r, int W) {
  return r * W - r * (r - 1) / 2;
}

__global__ void __launch_bounds__(kTile * kMaskSplit)
    nms_mask_tri_kernel(const float* __restrict__ boxes, int K, int W,
                        float thr, u64* __restrict__ mask) {
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int t = threadIdx.x % kTile;   // row in the block
  const int q = threadIdx.x / kTile;   // which 16 of the 64 columns
  // the row block r with tiles_before(r) <= tile < tiles_before(r + 1)
  const float n = 2.f * W + 1.f;
  int r = static_cast<int>((n - sqrtf(n * n - 8.f * tile)) * 0.5f);
  r = max(0, min(r, W - 1));
  while (r > 0 && tiles_before(r, W) > tile) --r;
  while (r + 1 < W && tiles_before(r + 1, W) <= tile) ++r;
  const int col_block = r + tile - tiles_before(r, W);
  const float* img = boxes + (size_t)b * K * 4;

  __shared__ Box cols[kTile];
  __shared__ u64 part[kMaskSplit][kTile];
  const int col0 = col_block * kTile;
  const int ncols = min(K - col0, kTile);
  if (threadIdx.x < ncols) {
    const float* p = img + (size_t)(col0 + threadIdx.x) * 4;
    cols[threadIdx.x] =
        Box{p[0], p[1], p[2], p[3], box_area(p[0], p[1], p[2], p[3])};
  }
  __syncthreads();

  const int i = r * kTile + t;
  u64 bits = 0ULL;
  if (i < K) {   // rows past K stay 0: the sweep stages whole blocks
    const float* p = img + (size_t)i * 4;
    const Box bi{p[0], p[1], p[2], p[3], box_area(p[0], p[1], p[2], p[3])};
    const int end = min((q + 1) * (kTile / kMaskSplit), ncols);
    int u = q * (kTile / kMaskSplit);
    if (col_block == r) u = max(u, t + 1);
    for (; u < end; ++u) {
      if (iou_above(bi, cols[u], thr)) bits |= 1ULL << u;
    }
  }
  part[q][t] = bits;
  __syncthreads();
  if (q == 0) {
    for (int k = 1; k < kMaskSplit; ++k) bits |= part[k][t];
    mask[((size_t)b * tiles_before(W, W) + tile) * kTile + t] = bits;
  }
}

// Copies the first kWindow tiles of row block r's run (words r..W-1 of its
// 64 rows) into `dst`, 16 bytes a thread per step. Runs start at multiples
// of 512 bytes.
__device__ __forceinline__ void stage_run(const u64* img, int r, int W,
                                          u64* dst) {
  const u64* src = img + (size_t)tiles_before(r, W) * kTile;
  const int chunks = min(W - r, kWindow) * kTile / 2;
  for (int q = threadIdx.x; q < chunks; q += kSweepThreads) {
    __pipeline_memcpy_async(dst + 2 * q, src + 2 * q, 16);
  }
}

__global__ void __launch_bounds__(kSweepThreads, 1)
    nms_block_sweep_kernel(const u64* __restrict__ mask,
                           const uint8_t* __restrict__ valid, int K, int W,
                           uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 smem[];
  // two stage buffers of 64 * min(W, kWindow) words, then `removed`
  const int stage = kTile * min(W, kWindow);
  u64* removed = smem + 2 * stage;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const u64* img = mask + (size_t)b * tiles_before(W, W) * kTile;
  const uint8_t* v = valid + (size_t)b * K;

  stage_run(img, 0, W, smem);
  __pipeline_commit();
  // seed `removed` with the invalid boxes and the tail past K
  for (int w = warp; w < W; w += kSweepWarps) {
    const int j0 = w * kTile + lane;
    const int j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 >= K || !v[j0]);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 >= K || !v[j1]);
    if (lane == 0) removed[w] = ((u64)hi << 32) | lo;
  }

  for (int c = 0; c < W; ++c) {
    const u64* cur = smem + (c & 1) * stage;
    const u64* run = img + (size_t)tiles_before(c, W) * kTile;
    __pipeline_wait_prior(0);   // this thread's copies of block c landed
    // every thread's copies of block c are visible, the propagation of block
    // c-1 is done (removed[c] is final) and the other buffer is free
    __syncthreads();
    if (c + 1 < W) stage_run(img, c + 1, W, smem + ((c + 1) & 1) * stage);
    __pipeline_commit();

    if (warp == 0) {   // b: resolve block c; every lane walks, lane 0 stores
      u64 diag[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) diag[t] = cur[t];
      u64 r = removed[c];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (!((r >> t) & 1ULL)) r |= diag[t];
      }
      if (lane == 0) removed[c] = r;
    }
    __syncthreads();

    // c: propagate the kept boxes of block c to the later words
    const u64 kept = ~removed[c];
    const bool kept_lo = (kept >> lane) & 1ULL;
    const bool kept_hi = (kept >> (lane + 32)) & 1ULL;
#pragma unroll 4
    for (int w = c + 1 + warp; w < W; w += kSweepWarps) {
      const u64* col = (w - c < kWindow ? cur : run) + (size_t)(w - c) * kTile;
      const u64 x = (kept_lo ? col[lane] : 0ULL) |
                    (kept_hi ? col[lane + 32] : 0ULL);
      const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)x);
      const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(x >> 32));
      if (lane == 0) removed[w] |= ((u64)hi << 32) | lo;
    }
  }
  // the last block propagates nothing: `removed` is final since the barrier
  // after its resolve

  uint8_t* out = keep + (size_t)b * K;
  for (int j = threadIdx.x; j < K; j += kSweepThreads) {
    out[j] = ((removed[j >> 6] >> (j & 63)) & 1ULL) ? 0 : 1;
  }
}

}  // namespace

static cudaError_t launch(const float* boxes, const uint8_t* valid, int B,
                          int K, float thr, u64* mask, uint8_t* keep,
                          cudaStream_t s) {
  const int W = (K + kTile - 1) / kTile;
  nms_mask_tri_kernel<<<dim3(tiles_before(W, W), B), kTile * kMaskSplit, 0,
                        s>>>(boxes, K, W, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t shmem =
      ((size_t)2 * kTile * min(W, kWindow) + W) * sizeof(u64);
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_block_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  nms_block_sweep_kernel<<<B, kSweepThreads, shmem, s>>>(mask, valid, K, W,
                                                          keep);
  return cudaGetLastError();
}

// boxes: (B, K, 4) float32, valid: (B, K) bool, mask: B * W(W+1)/2 * 64 words
// of uint64 scratch with W = ceil(K / 64), keep: (B, K) bool, all on CUDA
// device `device`. Launches on `stream` with `device` current, restores the
// caller's device, does not synchronise, and returns the first CUDA error of
// the launches (cudaGetLastError) or of the device switch.
extern "C" int nms_keep_launch(const float* boxes, const uint8_t* valid,
                               int B, int K, float thr, u64* mask,
                               uint8_t* keep, int device, void* stream) {
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(boxes, valid, B, K, thr, mask, keep,
               static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* nms_keep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
