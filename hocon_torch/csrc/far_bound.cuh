// The far-face bound that K1 (raster_fwd.cu) and K2 (raster_bwd.cu) skip by.
//
// Both kernels evaluate a face's coverage from its plane rows at pixel
// centres: the edge rows s_e, the along-edge rows u_e and the edge lengths
// L_e (rows 0-2, 3-5 and the constant of rows 6-8) give the logits
// -min_e(s_e^2 + ov_e^2) / sigma^2 outside the triangle, with the overhang
// ov = max(-u, u - L, 0). face_far bounds that from below over a rectangle
// of pixel centres [xa, xb] x [ya, yb] (0 <= xa <= xb, 0 <= ya <= yb; a
// 32-pixel row segment for K2, a tile for K1), so that a kernel can skip a
// (face, rectangle) pair whose f32 contribution its own source note shows
// to be exactly zero once the logits are below -far_logit.
//
// The bound. Each row is affine, so over the rectangle its exact value lies
// between its smallest and largest corner value. Per edge, min |s| is at
// least max(lo, -hi) (0 if the sign can change) and min ov at least
// max(-u_hi, u_lo - L) (ov is convex in u); s^2 + ov^2 is at least the sum
// of the two squares. The face is far when every edge's bound, over
// sigma^2, exceeds far_logit and some edge is <= 0 on the whole rectangle
// (so no pixel is inside).
//
// The margin. A kernel evaluates each row per pixel in f32, fused or not;
// the bound evaluates it at the corners. Either evaluation lies within
// 3 * 2^-24 * mag of the exact affine value, mag = |a0| x + |a1| y + |a2|,
// largest at the far corner (xb, yb). So every corner value is widened by
// kRowTol * mag = 2^-20 * mag (more than twice the 6 * 2^-24 * mag that the
// two evaluations can differ by). That margin scales with the row's own
// coefficients, so the large rows of rim slivers (a ~1/det cancellation)
// get a margin to match. What is left is relative rounding in squaring,
// summing and scaling by 1 / sigma^2: a few parts in 1e7, which each
// kernel's threshold leaves room for. The bound is computed with __fmul_rn
// / __fadd_rn, so no contraction moves it, and
// hocon_torch/render/raster_cuda.py:far_faces mirrors it op for op.

#pragma once

#include <cuda_runtime.h>

namespace hocon_far {

constexpr float kRowTol = 0x1p-20f;  // row evaluation margin per unit of magnitude

// Row (a0, a1, a2) over the rectangle: its smallest and largest corner
// value and the margin that covers any f32 evaluation at a pixel inside.
struct RowSpan {
  float lo, hi, tol;
};

__device__ __forceinline__ RowSpan row_span(float a0, float a1, float a2, float xa, float xb,
                                            float ya, float yb) {
  const float base_a = __fadd_rn(__fmul_rn(a1, ya), a2);
  const float base_b = __fadd_rn(__fmul_rn(a1, yb), a2);
  const float v0 = __fadd_rn(__fmul_rn(a0, xa), base_a);
  const float v1 = __fadd_rn(__fmul_rn(a0, xb), base_a);
  const float v2 = __fadd_rn(__fmul_rn(a0, xa), base_b);
  const float v3 = __fadd_rn(__fmul_rn(a0, xb), base_b);
  const float mag =
      __fadd_rn(__fadd_rn(__fmul_rn(fabsf(a0), xb), __fmul_rn(fabsf(a1), yb)), fabsf(a2));
  return {fminf(fminf(v0, v1), fminf(v2, v3)), fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)),
          __fmul_rn(mag, kRowTol)};
}

// True when the face with plane rows `a` (at least rows 0-8, 3 floats each)
// has logits below -far_logit at every pixel centre of the rectangle and no
// pixel inside it.
template <typename Rows>
__device__ __forceinline__ bool face_far(const Rows& a, float xa, float xb, float ya, float yb,
                                         float inv_sigma_sq, float far_logit) {
  float lb = __int_as_float(0x7f800000);  // +inf
  bool outside = false;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const RowSpan s = row_span(a[3 * e], a[3 * e + 1], a[3 * e + 2], xa, xb, ya, yb);
    const RowSpan u =
        row_span(a[3 * (3 + e)], a[3 * (3 + e) + 1], a[3 * (3 + e) + 2], xa, xb, ya, yb);
    const float len = a[3 * (6 + e) + 2];
    const float s_lb = fmaxf(__fsub_rn(fmaxf(s.lo, -s.hi), s.tol), 0.0f);
    const float ov_lb = fmaxf(__fsub_rn(fmaxf(-u.hi, __fsub_rn(u.lo, len)), u.tol), 0.0f);
    lb = fminf(lb, __fadd_rn(__fmul_rn(s_lb, s_lb), __fmul_rn(ov_lb, ov_lb)));
    outside = outside || __fadd_rn(s.hi, s.tol) <= 0.0f;
  }
  return outside && __fmul_rn(lb, inv_sigma_sq) > far_logit;
}

}  // namespace hocon_far
