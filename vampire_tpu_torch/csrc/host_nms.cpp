// Host NMS of the detection head's decoded boxes.
//
// The port's own copy of the three NMS routines of the JAX package's
// vampire_tpu/csrc/vampire_host.cpp (the reference runs them as numba
// kernels after a device->host round trip, bev_depth_head.py:426-463).
// vampire_tpu_torch/ops/nms.py builds it with the host C++ compiler into
// build/vampire_tpu_torch/ at first use and loads it with ctypes; the numpy
// loops beside the bindings are the plain versions the tests hold it to.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Circular NMS (mmdet3d.models.dense_heads.centerpoint_head.circle_nms).
// dets: n rows of (x, y, score); thresh compares SQUARED center distance.
// keep: out buffer of capacity post_max_size; returns number kept.
int circle_nms(const float* dets, int n, float thresh, int post_max_size,
               int* keep) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 3 + 2] > dets[b * 3 + 2];
  });
  std::vector<uint8_t> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n && kept < post_max_size; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep[kept++] = i;
    float xi = dets[i * 3], yi = dets[i * 3 + 1];
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      float dx = xi - dets[j * 3], dy = yi - dets[j * 3 + 1];
      if (dx * dx + dy * dy <= thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Size-aware circular NMS (bev_depth_head.py:33-82).
// dets: n rows of (x, y, dx, dy, yaw, score).
int size_aware_circle_nms(const float* dets, int n, float thresh_scale,
                          int post_max_size, int* keep) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 6 + 5] > dets[b * 6 + 5];
  });
  std::vector<uint8_t> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n && kept < post_max_size; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep[kept++] = i;
    const float* di = dets + i * 6;
    float ci = std::fabs(std::cos(di[4])), si = std::fabs(std::sin(di[4]));
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 6;
      float cj = std::fabs(std::cos(dj[4])), sj = std::fabs(std::sin(dj[4]));
      float dist_x = std::fabs(di[0] - dj[0]);
      float dist_y = std::fabs(di[1] - dj[1]);
      float th_x = std::fabs(di[2]) * ci + std::fabs(dj[2]) * cj +
                   std::fabs(di[3]) * si + std::fabs(dj[3]) * sj;
      float th_y = std::fabs(di[2]) * si + std::fabs(dj[2]) * sj +
                   std::fabs(di[3]) * ci + std::fabs(dj[3]) * cj;
      if (dist_x <= th_x * thresh_scale / 2.f &&
          dist_y <= th_y * thresh_scale / 2.f)
        suppressed[j] = 1;
    }
  }
  return kept;
}

// Rotated-rectangle NMS (mmdet3d nms_gpu semantics: greedy by score,
// suppress when rotated-BEV IoU > thresh). Used by the reference's
// nms_type='rotate' branch via CenterHead.get_task_detections
// (bev_depth_head.py:473-475; unused by every shipped config).
// boxes: n rows of (cx, cy, w, h, yaw); yaw rotates the w axis.
namespace {

struct Pt {
  double x, y;
};

// corners of a rotated rect, counter-clockwise
inline void rect_corners(const float* b, Pt* out) {
  double c = std::cos((double)b[4]), s = std::sin((double)b[4]);
  double hw = b[2] * 0.5, hh = b[3] * 0.5;
  double dx[4] = {-hw, hw, hw, -hw};
  double dy[4] = {-hh, -hh, hh, hh};
  for (int k = 0; k < 4; ++k) {
    out[k].x = b[0] + dx[k] * c - dy[k] * s;
    out[k].y = b[1] + dx[k] * s + dy[k] * c;
  }
}

inline double poly_area(const Pt* p, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return std::abs(a) * 0.5;
}

// Sutherland-Hodgman: clip `poly` by the half-plane left of edge a->b
inline int clip_edge(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    Pt cur = poly[i], nxt = poly[(i + 1) % n];
    double dc = (b.x - a.x) * (cur.y - a.y) - (b.y - a.y) * (cur.x - a.x);
    double dn = (b.x - a.x) * (nxt.y - a.y) - (b.y - a.y) * (nxt.x - a.x);
    bool in_c = dc >= 0, in_n = dn >= 0;
    if (in_c) out[m++] = cur;
    if (in_c != in_n) {
      double t = dc / (dc - dn);
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

inline double rect_iou(const float* b1, const float* b2) {
  Pt p1[4], p2[4];
  rect_corners(b1, p1);
  rect_corners(b2, p2);
  // clip p1 by each edge of p2 (p2 is CCW -> interior is left of edges)
  Pt bufa[16], bufb[16];
  int n = 4;
  const Pt* cur = p1;
  Pt* dst = bufa;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(cur, n, p2[e], p2[(e + 1) % 4], dst);
    cur = dst;
    dst = (dst == bufa) ? bufb : bufa;
  }
  double inter = n > 0 ? poly_area(cur, n) : 0.0;
  double a1 = (double)b1[2] * b1[3], a2 = (double)b2[2] * b2[3];
  double uni = a1 + a2 - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // namespace

// boxes: n rows of (cx, cy, w, h, yaw); scores: n. Greedy keep by
// descending score; suppress IoU > thresh. Returns number kept.
int rotated_nms(const float* boxes, const float* scores, int n, float thresh,
                int post_max_size, int* keep) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] > scores[b];
  });
  std::vector<uint8_t> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n && kept < post_max_size; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep[kept++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      if (rect_iou(boxes + i * 5, boxes + j * 5) > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

}  // extern "C"
