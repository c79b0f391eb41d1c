// Exact IoU of quadrilaterals on the host (counterpart of csrc/polyiou.cpp),
// with the arithmetic of devkit/polygon.py's numpy poly_iou, so that every
// IoU equals that function's bit for bit:
//
//   * each quad turned counter-clockwise (reversed unless its signed area
//     is >= 0), the clip polygon turned again if its signed area is < 0;
//   * the subject clipped by each edge of the clip polygon in turn
//     (Sutherland-Hodgman, a point inside where its side is >= 0), the
//     crossing at t = prev_side / (prev_side - cur_side);
//   * signed areas as 0.5 * np.sum of the shoelace terms
//     x_i * y_{i+1} - x_{i+1} * y_i, summed in numpy's pairwise order;
//   * the intersection's |area| (0 below 3 vertices), the union
//     (a1 + a2) - inter, and 0 where the union is <= 0.
//
// Built by devkit/native.py with -ffp-contract=off: a fused multiply-add
// rounds once where numpy rounds twice.  Plain C ABI, loaded with ctypes.

#include <cmath>
#include <cstdint>

namespace {

struct Pt {
  double x, y;
};

// A subject of 4 vertices gains at most its own count at each of the 4
// clips (each edge gives a crossing and its end point): 64 at most.
constexpr int kCap = 64;

// np.sum of n float64 terms: numpy's pairwise sum.  Below 8 terms one
// after another; up to 128, eight accumulators over strides of 8, joined
// as ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the rest one
// after another; above, the two halves (the first a multiple of 8).
double np_sum(const double* a, int n) {
  if (n < 8) {
    double r = 0.0;
    for (int i = 0; i < n; ++i) r += a[i];
    return r;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int i = 8;
    for (; i < n - n % 8; i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return np_sum(a, n2) + np_sum(a + n2, n - n2);
}

// polygon_area_signed: 0 below 3 vertices.
double signed_area(const Pt* p, int n) {
  if (n < 3) return 0.0;
  double t[kCap];
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    t[i] = u.x * v.y - v.x * u.y;
  }
  return 0.5 * np_sum(t, n);
}

void reverse4(Pt* p) {
  Pt a = p[0], b = p[1];
  p[0] = p[3];
  p[1] = p[2];
  p[2] = b;
  p[3] = a;
}

// orient_ccw: reversed unless the signed area is >= 0 (a NaN reverses).
void orient(Pt* p) {
  if (!(signed_area(p, 4) >= 0)) reverse4(p);
}

void load(const double* q, Pt* p) {
  for (int i = 0; i < 4; ++i) p[i] = {q[2 * i], q[2 * i + 1]};
}

// Half-plane left of a -> b; n + its crossings vertices at most.
int clip_edge(const Pt* in, int n, Pt a, Pt b, Pt* out) {
  const double ex = b.x - a.x, ey = b.y - a.y;
  int m = 0;
  Pt prev = in[n - 1];
  double prev_side = ex * (prev.y - a.y) - ey * (prev.x - a.x);
  for (int i = 0; i < n; ++i) {
    const Pt cur = in[i];
    const double cur_side = ex * (cur.y - a.y) - ey * (cur.x - a.x);
    if (cur_side >= 0) {
      if (prev_side < 0) {
        const double t = prev_side / (prev_side - cur_side);
        out[m++] = {prev.x + t * (cur.x - prev.x), prev.y + t * (cur.y - prev.y)};
      }
      out[m++] = cur;
    } else if (prev_side >= 0) {
      const double t = prev_side / (prev_side - cur_side);
      out[m++] = {prev.x + t * (cur.x - prev.x), prev.y + t * (cur.y - prev.y)};
    }
    prev = cur;
    prev_side = cur_side;
  }
  return m;
}

// poly_iou of an oriented subject a and an oriented clip quad b.
double iou_oriented(const Pt* a, const Pt* b) {
  Pt cp[4] = {b[0], b[1], b[2], b[3]};
  if (signed_area(cp, 4) < 0) reverse4(cp);
  Pt buf[2][kCap];
  for (int i = 0; i < 4; ++i) buf[0][i] = a[i];
  int n = 4, src = 0;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(buf[src], n, cp[e], cp[(e + 1) % 4], buf[1 - src]);
    src = 1 - src;
  }
  const double inter = std::fabs(signed_area(buf[src], n));
  const double a1 = std::fabs(signed_area(a, 4));
  const double a2 = std::fabs(signed_area(b, 4));
  const double uni = a1 + a2 - inter;
  if (uni <= 0) return 0.0;
  return inter / uni;
}

double quad_iou(const double* q1, const double* q2) {
  Pt a[4], b[4];
  load(q1, a);
  load(q2, b);
  orient(a);
  orient(b);
  return iou_oriented(a, b);
}

}  // namespace

extern "C" {

// out[i] = IoU(p1[i], p2[i]); rows of 8 doubles (x0 y0 ... x3 y3).
void poly_iou_pairs(const double* p1, const double* p2, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = quad_iou(p1 + 8 * i, p2 + 8 * i);
}

// out[i * m + j] = IoU(p1[i], p2[j]).
void poly_iou_matrix(const double* p1, int64_t n, const double* p2, int64_t m,
                     double* out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = quad_iou(p1 + 8 * i, p2 + 8 * j);
}

// out[k] = IoU(q, polys[k]), q the subject: poly_nms's IoUs of a pick.
void poly_iou_one_many(const double* q, const double* polys, int64_t n,
                       double* out) {
  Pt a[4];
  load(q, a);
  orient(a);
  for (int64_t k = 0; k < n; ++k) {
    Pt b[4];
    load(polys + 8 * k, b);
    orient(b);
    out[k] = iou_oriented(a, b);
  }
}

}  // extern "C"
