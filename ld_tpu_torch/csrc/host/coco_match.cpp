// Native COCO detection<->gt matcher: the inner loop of COCOeval.evaluateImg.
//
// The port's copy of ld_tpu/native/coco_match.cpp. It replaces the
// per-(image, category) greedy matching loops of the numpy matcher
// (ld_tpu_torch/evaluation/coco_eval.py:_match_numpy, the plain version)
// with -O3 C++; the accumulate stage stays vectorized numpy.
//
// Build: ld_tpu_torch/native.py (g++ -O3 -shared -fPIC, at first use).
//
// Contract (all row-major float64/uint8):
//   det_boxes (D, 4) xyxy sorted by descending score (pre-truncated to
//     maxDet), gt_boxes (G, 4) sorted ignored-last, gt_crowd (G,),
//   gt_ignore (G,), iou_thrs (T,)
// Outputs: dtm (T, D) uint8, dt_ignore (T, D) uint8.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

static inline double box_iou(const double* a, const double* b, bool crowd) {
  const double iw =
      std::min(a[2], b[2]) - std::max(a[0], b[0]);
  if (iw <= 0) return 0.0;
  const double ih =
      std::min(a[3], b[3]) - std::max(a[1], b[1]);
  if (ih <= 0) return 0.0;
  const double inter = iw * ih;
  const double area_d = (a[2] - a[0]) * (a[3] - a[1]);
  const double area_g = (b[2] - b[0]) * (b[3] - b[1]);
  const double uni = crowd ? area_d : area_d + area_g - inter;
  return uni <= 0 ? 0.0 : inter / uni;
}

// Greedy matching for one (image, category): detections in score order take
// the best available gt above the threshold; crowd gts may match repeatedly;
// gts are sorted counted-first so an ignored gt never outranks a counted
// match (pycocotools semantics).
void coco_match(const double* det_boxes, int64_t num_det,
                const double* gt_boxes, const uint8_t* gt_crowd,
                const uint8_t* gt_ignore, int64_t num_gt,
                const double* iou_thrs, int64_t num_thr,
                const double* area_rng,  // [lo, hi] for det out-of-range test
                uint8_t* dtm, uint8_t* dt_ignore) {
  // precompute ious (D x G)
  std::vector<double> ious((size_t)num_det * num_gt);
  for (int64_t d = 0; d < num_det; ++d)
    for (int64_t g = 0; g < num_gt; ++g)
      ious[d * num_gt + g] =
          box_iou(det_boxes + 4 * d, gt_boxes + 4 * g, gt_crowd[g] != 0);

  std::vector<uint8_t> gt_matched(num_gt);
  for (int64_t t = 0; t < num_thr; ++t) {
    std::fill(gt_matched.begin(), gt_matched.end(), 0);
    const double thr = iou_thrs[t];
    for (int64_t d = 0; d < num_det; ++d) {
      double best = std::min(thr, 1.0 - 1e-10);
      int64_t best_g = -1;
      for (int64_t g = 0; g < num_gt; ++g) {
        if (gt_matched[g] && !gt_crowd[g]) continue;
        if (best_g > -1 && !gt_ignore[best_g] && gt_ignore[g]) break;
        const double iou = ious[d * num_gt + g];
        if (iou < best) continue;
        best = iou;
        best_g = g;
      }
      if (best_g < 0) continue;
      gt_matched[best_g] = 1;
      dtm[t * num_det + d] = 1;
      dt_ignore[t * num_det + d] = gt_ignore[best_g];
    }
    // unmatched dets outside the area range are ignored, not false positives
    for (int64_t d = 0; d < num_det; ++d) {
      if (dtm[t * num_det + d]) continue;
      const double* b = det_boxes + 4 * d;
      const double area = (b[2] - b[0]) * (b[3] - b[1]);
      if (area < area_rng[0] || area > area_rng[1])
        dt_ignore[t * num_det + d] = 1;
    }
  }
}

}  // extern "C"
