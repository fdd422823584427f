// Greedy-NMS keep mask over score-sorted boxes, batched over images.
//
// Replaces the Pallas TPU kernel `_nms_fixpoint_kernel`
// (ld_tpu/ops/pallas_nms.py:23, launched by `pallas_nms_keep` :64-95). That
// kernel builds the strict-upper-triangular IoU > thr matrix in VMEM and
// iterates `keep <- valid & !(keep . S > 0.5)` on the MXU until it stops
// changing. The fixpoint is exactly greedy NMS, so this port computes greedy
// NMS directly instead of carrying the matrix iteration over:
//
//   1. nms_mask_kernel: grid (ceil(K/64), ceil(K/64), B), 64 threads. The
//      block stages a tile of 64 column boxes in shared memory; thread t owns
//      row i and writes one 64-bit word whose bit c is set when
//      j = col0 + c > i and IoU(i, j) > thr. Tiles left of the diagonal hold
//      no j > i and write 0 without computing anything.
//   2. nms_sweep_kernel: one warp per image. A `removed` bit vector of
//      ceil(K/64) words lives in shared memory, seeded with the invalid
//      boxes. Walking i in score order, a box whose bit is still clear is
//      kept and its mask row is ORed into `removed`. Invalid boxes are never
//      kept and so never suppress, as in the JAX fixpoint, where keep starts
//      at `valid`. At the end keep[j] = !removed[j].
//
// What bounds it on an H100: not bytes (18 B per box in, 1 B out) and not
// operations (~14 float ops per pair, K^2/2 pairs: 7.3 MFLOP at K = 1024,
// about 0.1 us at the 67 TFLOP/s float32 rate), but latency. The sweep is a
// chain of K dependent steps, one warp long, and each kept box waits on one
// L2 read of its mask row. The design keeps that chain short: no block-wide
// barriers (one warp, __syncwarp), the bit test reads shared memory, only the
// words right of the diagonal are ORed, and the whole mask of an image
// (K * K / 8 bytes, 128 KiB at K = 1024) stays in the 50 MB L2 between the
// two kernels.
//
// IoU is computed bit for bit as the plain version computes it (the JAX
// `bbox_overlaps` order): area = (x2-x1)*(y2-y1), inter = clamp(w,0) *
// clamp(h,0), union = max(a_i + a_j - inter, 1e-6), iou = inter / union, with
// the round-to-nearest intrinsics and the file compiled with --fmad=false, so
// no product is fused into an add. A comparison that flips at the threshold
// would change the keep set.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

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

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int K, int W,
                                float thr,
                                unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  const int t = threadIdx.x;
  const float* img = boxes + (size_t)b * K * 4;

  __shared__ Box tile[kTile];
  const int col0 = col_block * kTile;
  const int ncols = min(K - col0, kTile);
  if (t < ncols) {
    const float* p = img + (size_t)(col0 + t) * 4;
    tile[t] = Box{p[0], p[1], p[2], p[3], box_area(p[0], p[1], p[2], p[3])};
  }
  __syncthreads();

  const int i = row_block * kTile + t;
  if (i >= K) return;
  unsigned long long bits = 0ULL;
  if (col_block >= row_block) {
    const float* p = img + (size_t)i * 4;
    const Box bi{p[0], p[1], p[2], p[3], box_area(p[0], p[1], p[2], p[3])};
    const int start = (col_block == row_block) ? t + 1 : 0;
    for (int c = start; c < ncols; ++c) {
      if (iou_above(bi, tile[c], thr)) bits |= 1ULL << c;
    }
  }
  mask[((size_t)b * K + i) * W + col_block] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int K,
                                 int W, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* v = valid + (size_t)b * K;

  // seed `removed` with the invalid boxes (and the tail past K)
  for (int w = 0; w < W; ++w) {
    const int j0 = w * kTile + lane;
    const int j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 >= K || !v[j0]);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 >= K || !v[j1]);
    if (lane == 0) removed[w] = ((unsigned long long)hi << 32) | lo;
  }
  __syncwarp();

  const unsigned long long* rows = mask + (size_t)b * K * W;
  for (int i = 0; i < K; ++i) {
    const unsigned long long r = removed[i >> 6];
    __syncwarp();
    if (!((r >> (i & 63)) & 1ULL)) {
      const unsigned long long* row = rows + (size_t)i * W;
      for (int w = (i >> 6) + lane; w < W; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }

  uint8_t* out = keep + (size_t)b * K;
  for (int j = lane; j < K; j += 32) {
    out[j] = ((removed[j >> 6] >> (j & 63)) & 1ULL) ? 0 : 1;
  }
}

}  // namespace

// boxes: (B, K, 4) float32, valid: (B, K) bool, mask: (B, K, W) uint64
// scratch with W = ceil(K / 64), keep: (B, K) bool. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int nms_keep_launch(const float* boxes, const uint8_t* valid,
                               int B, int K, float thr,
                               unsigned long long* mask, uint8_t* keep,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = (K + kTile - 1) / kTile;
  const dim3 grid(W, W, B);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(boxes, K, W, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shmem = (size_t)W * sizeof(unsigned long long);
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<B, 32, shmem, s>>>(mask, valid, K, W, keep);
  return static_cast<int>(cudaGetLastError());
}
