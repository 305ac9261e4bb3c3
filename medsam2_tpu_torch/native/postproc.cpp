// Host-side post-processing of the PyTorch port, in C++: the fortran-order
// RLE codec of the AMG records, greedy box NMS, greedy point NMS, and the
// instance-overlap histogram of the AJI / PQ metrics. A copy of the JAX
// package's ``medsam2_tpu/native/postproc.cpp``, kept here so that the port
// builds nothing of that package. Compiled with g++ at first use
// (``medsam2_tpu_torch/native/__init__.py``); the numpy versions beside the
// callers are the tests' oracles, not a fallback.
//
// All functions use C linkage and plain pointers for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Fortran-order RLE encode of a binary mask (matches amg.py:109-137).
// mask: [h*w] uint8 row-major. counts_out must hold >= h*w + 2 ints.
// Returns the number of counts written.
int rle_encode(const uint8_t* mask, int h, int w, int32_t* counts_out) {
  const int64_t n = static_cast<int64_t>(h) * w;
  int m = 0;
  // fortran order: iterate columns of the row-major mask
  uint8_t prev = mask[0];  // first element in fortran order is (0, 0)
  if (prev) counts_out[m++] = 0;  // leading zero-run when mask starts with 1
  int32_t run = 0;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      uint8_t v = mask[static_cast<int64_t>(y) * w + x];
      if (v == prev) {
        ++run;
      } else {
        counts_out[m++] = run;
        run = 1;
        prev = v;
      }
    }
  }
  counts_out[m++] = run;
  (void)n;
  return m;
}

// RLE decode into a row-major uint8 mask.
void rle_decode(const int32_t* counts, int n_counts, int h, int w, uint8_t* out) {
  std::vector<uint8_t> flat(static_cast<size_t>(h) * w);
  int64_t idx = 0;
  uint8_t parity = 0;
  for (int i = 0; i < n_counts; ++i) {
    for (int32_t k = 0; k < counts[i]; ++k) flat[idx++] = parity;
    parity = 1 - parity;
  }
  // flat is fortran order; transpose to row-major
  for (int x = 0; x < w; ++x)
    for (int y = 0; y < h; ++y)
      out[static_cast<int64_t>(y) * w + x] = flat[static_cast<int64_t>(x) * h + y];
}

// Greedy box NMS. boxes: [n, 4] xyxy, scores: [n]. keep_out: caller-allocated
// [n] int32. Returns the number kept (indices in descending-score order).
int greedy_nms(const float* boxes, const float* scores, int n, float iou_thr,
               int32_t* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<uint8_t> suppressed(n, 0);
  std::vector<float> area(n);
  for (int i = 0; i < n; ++i) {
    area[i] = (boxes[4 * i + 2] - boxes[4 * i]) * (boxes[4 * i + 3] - boxes[4 * i + 1]);
  }
  int m = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[m++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      float x0 = std::max(bi[0], bj[0]);
      float y0 = std::max(bi[1], bj[1]);
      float x1 = std::min(bi[2], bj[2]);
      float y1 = std::min(bi[3], bj[3]);
      float inter = std::max(0.f, x1 - x0) * std::max(0.f, y1 - y0);
      float uni = area[i] + area[j] - inter;
      if (uni > 0 && inter / uni > iou_thr) suppressed[j] = 1;
    }
  }
  return m;
}

// Greedy distance-based point NMS (modeling/utils.py:342-355 semantics).
int point_nms(const float* pts, const float* scores, int n, float dist_thr,
              int32_t* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<uint8_t> suppressed(n, 0);
  float d2 = dist_thr * dist_thr;
  int m = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[m++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      float dx = pts[2 * i] - pts[2 * j];
      float dy = pts[2 * i + 1] - pts[2 * j + 1];
      if (dx * dx + dy * dy < d2) suppressed[j] = 1;
    }
  }
  return m;
}

// Instance-overlap histogram for AJI/PQ: one pass over two int32 label maps
// (ids must be in [0, n_t] / [0, n_p]). Outputs:
//   inter [n_t * n_p]  pairwise intersections (1-indexed ids -> 0-indexed)
//   t_areas [n_t], p_areas [n_p]
void instance_overlap(const int32_t* true_map, const int32_t* pred_map,
                      int64_t n_pixels, int n_t, int n_p, double* inter,
                      double* t_areas, double* p_areas) {
  std::memset(inter, 0, sizeof(double) * n_t * n_p);
  std::memset(t_areas, 0, sizeof(double) * n_t);
  std::memset(p_areas, 0, sizeof(double) * n_p);
  for (int64_t i = 0; i < n_pixels; ++i) {
    int t = true_map[i];
    int p = pred_map[i];
    if (t > 0) t_areas[t - 1] += 1;
    if (p > 0) p_areas[p - 1] += 1;
    if (t > 0 && p > 0) inter[static_cast<int64_t>(t - 1) * n_p + (p - 1)] += 1;
  }
}

}  // extern "C"
