// Native evaluation kernels for the KITTI-official AP computation.
//
// Copy of crb_active_3ddet_tpu/native/kitti_eval.cpp: host C++ on the CPU,
// built by native/__init__.py into the package's _build/ directory.
//
// Replaces the reference's numba.cuda rotated-IoU kernel
// (pcdet/datasets/kitti/kitti_object_eval_python/rotate_iou.py) and the
// numba.jit statistics loops (eval.py: compute_statistics_jit :157-275,
// fused_compute_statistics :291-341).  The host-side evaluation has no device
// work in it, so a small C++ library (built once, loaded via ctypes) is the
// right tool: exact same greedy-assignment semantics, ~1000x faster than
// pure Python.
//
// Box layout for rotated overlap: (cx, cy, w, h, angle) — the camera-frame
// (x, z, l, w, ry) slices the Python wrapper feeds in, matching
// eval.py:calculate_iou_partly metric=1/2.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// corners of rotated rect (cx, cy, w, h, angle), CCW
inline void rect_corners(const double* b, Pt* c) {
  const double cx = b[0], cy = b[1], w2 = b[2] * 0.5, h2 = b[3] * 0.5;
  const double ca = std::cos(b[4]), sa = std::sin(b[4]);
  const double dx[4] = {w2, -w2, -w2, w2};
  const double dy[4] = {h2, h2, -h2, -h2};
  for (int i = 0; i < 4; ++i) {
    c[i].x = dx[i] * ca - dy[i] * sa + cx;
    c[i].y = dx[i] * sa + dy[i] * ca + cy;
  }
}

// Sutherland–Hodgman clip of convex polygon by halfplane left of e1->e2
inline int clip_halfplane(const Pt* in, int n, Pt e1, Pt e2, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& v = in[i];
    const Pt& vn = in[(i + 1) % n];
    const double d = cross(e1, e2, v);
    const double dn = cross(e1, e2, vn);
    if (d >= 0) out[m++] = v;
    if ((d >= 0) != (dn >= 0)) {
      const double denom = d - dn;
      const double t = (std::abs(denom) < 1e-12) ? 0.0 : d / denom;
      out[m].x = v.x + t * (vn.x - v.x);
      out[m].y = v.y + t * (vn.y - v.y);
      ++m;
    }
  }
  return m;
}

inline double poly_area(const Pt* p, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return std::abs(a) * 0.5;
}

inline double rect_inter_area(const double* ba, const double* bb) {
  Pt ca[4], cb[4];
  rect_corners(ba, ca);
  rect_corners(bb, cb);
  Pt buf1[16], buf2[16];
  std::memcpy(buf1, ca, sizeof(ca));
  int n = 4;
  for (int e = 0; e < 4; ++e) {
    n = clip_halfplane(buf1, n, cb[e], cb[(e + 1) % 4], buf2);
    if (n == 0) return 0.0;
    std::memcpy(buf1, buf2, n * sizeof(Pt));
  }
  return poly_area(buf1, n);
}

}  // namespace

extern "C" {

// boxes: (n, 5), qboxes: (k, 5) row-major double; out: (n, k)
// criterion: -1 IoU, 0 /area_a, 1 /area_b, else raw intersection area
void rotated_overlap(const double* boxes, int64_t n, const double* qboxes,
                     int64_t k, int criterion, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* ba = boxes + i * 5;
    const double area_a = ba[2] * ba[3];
    for (int64_t j = 0; j < k; ++j) {
      const double* bb = qboxes + j * 5;
      const double inter = rect_inter_area(ba, bb);
      double ua;
      if (criterion == -1) ua = area_a + bb[2] * bb[3] - inter;
      else if (criterion == 0) ua = area_a;
      else if (criterion == 1) ua = bb[2] * bb[3];
      else ua = 1.0;
      out[i * k + j] = (ua > 0) ? inter / ua : 0.0;
    }
  }
}

// camera-frame 3D overlap: boxes (n, 7) [x, y, z, l, h, w, ry];
// rinc: (n, k) raw BEV intersection areas (criterion=2), overwritten with 3D
// IoU.  Parity: eval.py d3_box_overlap_kernel:124-150.
void d3_overlap_kernel(const double* boxes, int64_t n, const double* qboxes,
                       int64_t k, double* rinc, int criterion) {
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < k; ++j) {
      double& r = rinc[i * k + j];
      if (r > 0) {
        const double* a = boxes + i * 7;
        const double* b = qboxes + j * 7;
        const double iw = std::min(a[1], b[1]) - std::max(a[1] - a[4], b[1] - b[4]);
        if (iw > 0) {
          const double area1 = a[3] * a[4] * a[5];
          const double area2 = b[3] * b[4] * b[5];
          const double inc = iw * r;
          double ua;
          if (criterion == -1) ua = area1 + area2 - inc;
          else if (criterion == 0) ua = area1;
          else if (criterion == 1) ua = area2;
          else ua = inc;
          r = inc / ua;
        } else {
          r = 0.0;
        }
      }
    }
  }
}

// axis-aligned 2D image-box overlap. boxes (n,4), qboxes (k,4) [x1,y1,x2,y2]
void image_overlap(const double* boxes, int64_t n, const double* qboxes,
                   int64_t k, int criterion, double* out) {
  for (int64_t j = 0; j < k; ++j) {
    const double* q = qboxes + j * 4;
    const double qarea = (q[2] - q[0]) * (q[3] - q[1]);
    for (int64_t i = 0; i < n; ++i) {
      const double* b = boxes + i * 4;
      const double iw = std::min(b[2], q[2]) - std::max(b[0], q[0]);
      double ov = 0.0;
      if (iw > 0) {
        const double ih = std::min(b[3], q[3]) - std::max(b[1], q[1]);
        if (ih > 0) {
          double ua;
          const double barea = (b[2] - b[0]) * (b[3] - b[1]);
          if (criterion == -1) ua = barea + qarea - iw * ih;
          else if (criterion == 0) ua = barea;
          else if (criterion == 1) ua = qarea;
          else ua = 1.0;
          ov = iw * ih / ua;
        }
      }
      out[i * k + j] = ov;
    }
  }
}

// Single-frame greedy assignment statistics.
// overlaps: (det, gt) row-major. Parity: eval.py compute_statistics_jit.
// Outputs: stats[0..3] = tp, fp, fn, similarity; thresholds gets the tp
// scores (size gt capacity), *num_thresh count.
void compute_statistics(const double* overlaps, int64_t det_size,
                        int64_t gt_size, const double* dt_scores,
                        const double* dt_alphas, const double* gt_alphas,
                        const double* dt_bboxes, const double* dc_bboxes,
                        int64_t dc_num, const int64_t* ignored_gt,
                        const int64_t* ignored_det, int metric,
                        double min_overlap, double thresh, int compute_fp,
                        int compute_aos, double* stats, double* thresholds,
                        int64_t* num_thresh) {
  std::vector<char> assigned(det_size, 0);
  std::vector<char> ignored_threshold(det_size, 0);
  if (compute_fp) {
    for (int64_t i = 0; i < det_size; ++i)
      if (dt_scores[i] < thresh) ignored_threshold[i] = 1;
  }
  const double NO_DETECTION = -10000000.0;
  int64_t tp = 0, fp = 0, fn = 0;
  double similarity = 0;
  std::vector<double> delta;
  int64_t thresh_idx = 0;

  for (int64_t i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0;
    bool assigned_ignored_det = false;

    for (int64_t j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1) continue;
      if (assigned[j]) continue;
      if (ignored_threshold[j]) continue;
      const double overlap = overlaps[j * gt_size + i];
      const double dt_score = dt_scores[j];
      if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == NO_DETECTION && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
      ++fn;
    } else if (valid_detection != NO_DETECTION &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != NO_DETECTION) {
      ++tp;
      thresholds[thresh_idx++] = dt_scores[det_idx];
      if (compute_aos) delta.push_back(gt_alphas[i] - dt_alphas[det_idx]);
      assigned[det_idx] = 1;
    }
  }

  if (compute_fp) {
    for (int64_t i = 0; i < det_size; ++i) {
      if (!(assigned[i] || ignored_det[i] == -1 || ignored_det[i] == 1 ||
            ignored_threshold[i]))
        ++fp;
    }
    int64_t nstuff = 0;
    if (metric == 0 && dc_num > 0) {
      std::vector<double> ov_dc(det_size * dc_num);
      image_overlap(dt_bboxes, det_size, dc_bboxes, dc_num, 0, ov_dc.data());
      for (int64_t i = 0; i < dc_num; ++i) {
        for (int64_t j = 0; j < det_size; ++j) {
          if (assigned[j]) continue;
          if (ignored_det[j] == -1 || ignored_det[j] == 1) continue;
          if (ignored_threshold[j]) continue;
          if (ov_dc[j * dc_num + i] > min_overlap) {
            assigned[j] = 1;
            ++nstuff;
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      similarity = -1;
      if (tp > 0 || fp > 0) {
        similarity = 0;
        for (double d : delta) similarity += (1.0 + std::cos(d)) / 2.0;
      }
    }
  }
  stats[0] = (double)tp;
  stats[1] = (double)fp;
  stats[2] = (double)fn;
  stats[3] = similarity;
  *num_thresh = thresh_idx;
}

// All-frames × all-thresholds PR accumulation.
// Layout: per-frame arrays are concatenated; offsets give starts.
// overlaps_flat: concatenation of per-frame (det, gt) matrices.
// pr: (num_thresholds, 4) accumulated [tp, fp, fn, similarity].
void fused_statistics(const double* overlaps_flat, const int64_t* ov_offsets,
                      const int64_t* gt_nums, const int64_t* dt_nums,
                      const int64_t* dc_nums, const int64_t* gt_offsets,
                      const int64_t* dt_offsets, const int64_t* dc_offsets,
                      const double* dt_scores, const double* dt_alphas,
                      const double* gt_alphas, const double* dt_bboxes,
                      const double* dc_bboxes, const int64_t* ignored_gts,
                      const int64_t* ignored_dets, int64_t num_frames,
                      int metric, double min_overlap,
                      const double* thresholds, int64_t num_thresholds,
                      int compute_aos, double* pr) {
  std::vector<double> thresh_buf;
  for (int64_t f = 0; f < num_frames; ++f) {
    const int64_t gt_n = gt_nums[f], dt_n = dt_nums[f], dc_n = dc_nums[f];
    thresh_buf.resize((size_t)std::max<int64_t>(gt_n, 1));
    for (int64_t t = 0; t < num_thresholds; ++t) {
      double stats[4];
      int64_t nth = 0;
      compute_statistics(
          overlaps_flat + ov_offsets[f], dt_n, gt_n,
          dt_scores + dt_offsets[f], dt_alphas + dt_offsets[f],
          gt_alphas + gt_offsets[f], dt_bboxes + dt_offsets[f] * 4,
          dc_bboxes + dc_offsets[f] * 4, dc_n, ignored_gts + gt_offsets[f],
          ignored_dets + dt_offsets[f], metric, min_overlap, thresholds[t],
          /*compute_fp=*/1, compute_aos, stats, thresh_buf.data(), &nth);
      pr[t * 4 + 0] += stats[0];
      pr[t * 4 + 1] += stats[1];
      pr[t * 4 + 2] += stats[2];
      if (stats[3] != -1) pr[t * 4 + 3] += stats[3];
    }
  }
}

}  // extern "C"
