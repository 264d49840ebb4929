// K2: soft-rasterizer backward for Hopper (sm_90a).
//
// Replaces hocon/render/raster_pallas.py:_raster_bwd_kernel (launched by
// _backward_pallas). Same function: dL/dcoeffs (B, Fp, 3R) from K1's padded
// outputs (sil, attr + zbar, vis, and the softmax state m, den) and their
// cotangents. For every (face, pixel) pair that K1 evaluated, it recomputes
// the face's affine rows, the signed squared distance and the coverage
// sigmoid, then chains the softmax competition, the silhouette, the strict
// 0 < zraw < 1 clip mask, the minima with ties split 1/2/3 ways and the
// overhang branches back to each row r, which gets
// (sum dval * x, sum dval * y, sum dval) over those pixels.
//
// Bound on this card: operations. Each pair costs ~236 f32 operations at
// C = 2 (the forward recompute, one exp and one divide, the chain, 36
// accumulations) against a few bytes per pixel, read once per chunk that
// reaches it.
//
// The TPU kernel keeps the whole (Fp, 3R) output resident and accumulates
// into it over a grid that runs in order; on this card blocks run in
// parallel, so that would race. Design: one block owns one (batch, face
// chunk) and so one 32 x 3R block of the output; no atomics, and the sums
// run in a fixed order, so a repeat run gives the same bits. The block
// walks the pixel cells in which K1 evaluated its chunk (the same y, x and
// chunk-range tests). Lane f of every warp owns face f of the chunk and
// keeps its 3R coefficients and 3R partial sums in registers; warp w takes
// row w of each 8-row cell, 32 columns (a row segment) at a time. A
// segment's per-pixel state (10 floats) is staged in shared memory by the
// warp that reads it, as broadcasts to its 32 lanes, so the warps run
// decoupled (__syncwarp only). At the end the 8 warps' partial sums meet in
// shared memory and are added in warp order, after the one block barrier.
//
// Skipping the pairs that add exactly zero. In f32 the coverage
// 1 / (1 + expf(-logits)) is exactly 0 once -logits exceeds ~88.7228:
// expf overflows to inf. Then what = 0 * expf(e_w) * inv_den (e_w <= 80),
// and dl, dx, dss and every row's dval are +-0, so the pair changes no sum
// (an accumulator that starts at +0 never holds -0, and x + (+-0) == x).
// Before staging a segment each lane bounds its own face over the
// segment's 32 pixels with face_far (far_bound.cuh, shared with K1: the
// rows at the segment's two ends, each widened by 2^-20 of its magnitude)
// at kFarLogit = 89, which leaves the 0.3 % between 88.7228 and 89 for the
// bound's relative rounding. When all 32 lanes are far (__all_sync) the
// warp skips the segment: no loads, no pairs. For finite inputs the result
// is bitwise that of evaluating every pair.

#include <cuda_runtime.h>

#include "far_bound.cuh"

namespace {

constexpr int kRowBlock = 8;  // ROW_BLOCK of the chunk ranges; one warp per row
constexpr int kTileW = 32;    // columns per row segment
constexpr int kFaces = 32;    // faces per chunk: one per lane
constexpr int kAttrs = 2;     // user attribute channels C (reference-view x, y)
constexpr float kFarLogit = 89.0f;  // expf(89) > FLT_MAX: the sigmoid is exactly 0
constexpr unsigned kAllLanes = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kFaces * kRowBlock)
raster_bwd_kernel(const int* __restrict__ krange,    // (B, NYB, 2)
                  const float* __restrict__ bounds,  // (B, NC, 4)
                  const float* __restrict__ coeffs,  // (B, Fp, 3R)
                  const float* __restrict__ sil,     // (B, Hp, Wp)
                  const float* __restrict__ attr,    // (B, C+1, Hp, Wp)
                  const float* __restrict__ vis,     // (B, Hp, Wp)
                  const float* __restrict__ mden,    // (B, 2, Hp, Wp)
                  const float* __restrict__ gsil,    // (B, Hp, Wp)
                  const float* __restrict__ gattr,   // (B, C+1, Hp, Wp)
                  const float* __restrict__ gvis,    // (B, Hp, Wp)
                  float* __restrict__ dcoeffs,       // (B, Fp, 3R)
                  int hp, int wp, int nyb, int nc, int fp, int lane_block,
                  float inv_sigma_sq, float inv_gamma) {
  constexpr int R3 = 3 * (10 + C);
  constexpr int kPix = kRowBlock * kTileW;  // staging slots: one per thread
  constexpr int kState = 6 + 2 * C;         // staged floats per pixel
  constexpr int kRedStride = R3 + 1;        // odd: conflict-free per-lane rows
  // Segment state, then (after the last segment) the warps' partial sums.
  __shared__ float smem[kRowBlock * kFaces * kRedStride];
  static_assert(kState * kPix <= kRowBlock * kFaces * kRedStride, "staging fits");

  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;  // face of the chunk
  const int warp = threadIdx.y;  // row of the cell
  const int tid = warp * kFaces + lane;

  const float* bnd = bounds + (static_cast<size_t>(b) * nc + k) * 4;
  const float ymin = bnd[0], ymax = bnd[1], xmin = bnd[2], xmax = bnd[3];

  float a[R3];
  float acc[R3];
  const float* cf = coeffs + (static_cast<size_t>(b) * fp + k * kFaces + lane) * R3;
#pragma unroll
  for (int j = 0; j < R3; ++j) {
    a[j] = cf[j];
    acc[j] = 0.0f;
  }

  const size_t plane = static_cast<size_t>(hp) * wp;
  const int nxb = wp / lane_block;
  for (int yi = 0; yi < nyb; ++yi) {
    // The cell tests of K1: uniform across the block.
    const float y_base = static_cast<float>(yi * kRowBlock);
    const int ks = krange[(b * nyb + yi) * 2];
    const int ke = krange[(b * nyb + yi) * 2 + 1];
    if (!(k >= ks && k < ke && y_base + kRowBlock > ymin && y_base < ymax)) continue;
    const float y = static_cast<float>(yi * kRowBlock + warp) + 0.5f;
    for (int xi = 0; xi < nxb; ++xi) {
      const float x_base = static_cast<float>(xi * lane_block);
      if (!(x_base + lane_block > xmin && x_base < xmax)) continue;
      for (int col0 = xi * lane_block; col0 < (xi + 1) * lane_block; col0 += kTileW) {
        const float xa = static_cast<float>(col0) + 0.5f;
        const float xb = static_cast<float>(col0 + kTileW - 1) + 0.5f;
        const bool far = hocon_far::face_far(a, xa, xb, y, y, inv_sigma_sq, kFarLogit);
        if (__all_sync(kAllLanes, far)) continue;
        __syncwarp();  // this warp's reads of its previous segment are done
        {
          // Lane l stages pixel (row y, column col0 + l) in this warp's slots.
          const size_t pix = static_cast<size_t>(yi * kRowBlock + warp) * wp + col0 + lane;
          const size_t bp = static_cast<size_t>(b) * plane + pix;
          const size_t ap = static_cast<size_t>(b) * (C + 1) * plane + pix;
          float* st = smem + tid;
          st[0 * kPix] = gsil[bp] * (1.0f - sil[bp]);
          st[1 * kPix] = mden[2 * static_cast<size_t>(b) * plane + pix];           // m
          st[2 * kPix] = 1.0f / mden[(2 * static_cast<size_t>(b) + 1) * plane + pix];  // 1/den
          st[3 * kPix] = gattr[ap + C * plane];  // g_z
          st[4 * kPix] = attr[ap + C * plane];   // out_z
          st[5 * kPix] = gvis[bp] * (1.0f - vis[bp]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            st[(6 + 2 * c) * kPix] = gattr[ap + c * plane];
            st[(7 + 2 * c) * kPix] = attr[ap + c * plane];
          }
        }
        __syncwarp();  // the segment's state is visible to all 32 lanes

        const float* st = smem + warp * kTileW;
#pragma unroll 1
        for (int j = 0; j < kTileW; ++j) {
          const float x = static_cast<float>(col0 + j) + 0.5f;
          const float gs1 = st[0 * kPix + j];
          const float m = st[1 * kPix + j];
          const float inv_den = st[2 * kPix + j];
          const float g_z = st[3 * kPix + j];
          const float out_z = st[4 * kPix + j];
          const float gv = st[5 * kPix + j];
          auto row = [&](int r) { return a[3 * r] * x + (a[3 * r + 1] * y + a[3 * r + 2]); };
          auto add_row = [&](int r, float dval) {
            acc[3 * r] += dval * x;
            acc[3 * r + 1] += dval * y;
            acc[3 * r + 2] += dval;
          };

          // The forward, recomputed.
          float s[3], u[3], len[3], ov[3], c2[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            s[e] = row(e);
            u[e] = row(3 + e);
            len[e] = a[3 * (6 + e) + 2];
            ov[e] = fmaxf(fmaxf(-u[e], u[e] - len[e]), 0.0f);
            c2[e] = s[e] * s[e] + ov[e] * ov[e];
          }
          const float d_in = fminf(fminf(s[0], s[1]), s[2]);
          const float dist2 = fminf(fminf(c2[0], c2[1]), c2[2]);
          const bool inside = d_in > 0.0f;
          const float signed_sq = inside ? d_in * d_in : -dist2;
          const float logits = signed_sq * inv_sigma_sq;
          const float zraw = row(9);
          const float z = fminf(fmaxf(zraw, 0.0f), 1.0f);
          const float sig = 1.0f / (1.0f + expf(-logits));
          // exp(l - m) as sig * exp(-z / gamma - m), the exponent clamped at
          // 80 (a face >= 8.9 sigma away, beyond the culling cutoff).
          const float e_w = fminf(-z * inv_gamma - m, 80.0f);
          const float what = sig * expf(e_w) * inv_den;

          // Softmax competition over the channels, then the direct terms.
          float ssum = g_z * (z - out_z) + gv;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float g_c = st[(6 + 2 * c) * kPix + j];
            const float out_c = st[(7 + 2 * c) * kPix + j];
            ssum += g_c * (row(10 + c) - out_c);
            add_row(10 + c, what * g_c);
          }
          const float dl = what * ssum;
          const float dx = gs1 * sig + dl * (1.0f - sig);  // silhouette + softmax
          const float clip_mask = (zraw > 0.0f && zraw < 1.0f) ? 1.0f : 0.0f;
          add_row(9, (what * g_z - dl * inv_gamma) * clip_mask);

          // Minima with ties split evenly (counts are exactly 1, 2 or 3).
          const float dss = dx * inv_sigma_sq;  // dL / d(signed_sq)
          float in_m[3], o_m[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            in_m[e] = s[e] == d_in ? 1.0f : 0.0f;
            o_m[e] = c2[e] == dist2 ? 1.0f : 0.0f;
          }
          auto rcp123 = [](float cnt) {
            return cnt == 1.0f ? 1.0f : (cnt == 2.0f ? 0.5f : 1.0f / 3.0f);
          };
          const float insf = inside ? 1.0f : 0.0f;
          const float in_sel = rcp123(in_m[0] + in_m[1] + in_m[2]) * insf;
          const float o_sel = rcp123(o_m[0] + o_m[1] + o_m[2]) * (1.0f - insf);
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float sel_in = in_m[e] * in_sel;
            const float sel_out = o_m[e] * o_sel;
            add_row(e, (2.0f * d_in * sel_in - 2.0f * s[e] * sel_out) * dss);
            // Overhang ov = max(-u, u - L, 0).
            const float a_side = -u[e];
            const float b_side = u[e] - len[e];
            const float take_b = (b_side >= a_side && b_side > 0.0f) ? 1.0f : 0.0f;
            const float take_a = (a_side > b_side && a_side > 0.0f) ? 1.0f : 0.0f;
            const float dov = -2.0f * ov[e] * sel_out * dss;  // dL / d(overhang)
            add_row(3 + e, dov * (take_b - take_a));
            add_row(6 + e, dov * (-take_b));
          }
        }
      }
    }
  }

  // The 8 warps' partial sums of each face, added in warp order.
  __syncthreads();
  float* mine = smem + (warp * kFaces + lane) * kRedStride;
#pragma unroll
  for (int j = 0; j < R3; ++j) mine[j] = acc[j];
  __syncthreads();
  float* out = dcoeffs + (static_cast<size_t>(b) * fp + k * kFaces) * R3;
  for (int o = tid; o < kFaces * R3; o += kPix) {
    const int f = o / R3;
    const int j = o - f * R3;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowBlock; ++w) sum += smem[(w * kFaces + f) * kRedStride + j];
    out[o] = sum;
  }
}

}  // namespace

// Launches K2 on `stream`; returns the cudaError_t of the launch. Every
// element of dcoeffs is written (zeros for chunks K1 never evaluated). Built
// for the one attribute count a caller passes (the warp's two reference-view
// pixel coordinates) and chunks of 32 faces.
extern "C" int hocon_raster_bwd(const int* krange, const float* bounds, const float* coeffs,
                                const float* sil, const float* attr, const float* vis,
                                const float* mden, const float* gsil, const float* gattr,
                                const float* gvis, float* dcoeffs, int b, int hp, int wp,
                                int nc, int fp, int n_user_attr, int lane_block,
                                float inv_sigma_sq, float inv_gamma, void* stream) {
  if (n_user_attr != kAttrs || fp != nc * kFaces || lane_block % kTileW != 0 ||
      wp % lane_block != 0 || hp % kRowBlock != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || nc == 0) return 0;
  const dim3 grid(nc, b);
  const dim3 block(kFaces, kRowBlock);
  raster_bwd_kernel<kAttrs><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      krange, bounds, coeffs, sil, attr, vis, mden, gsil, gattr, gvis, dcoeffs, hp, wp,
      hp / kRowBlock, nc, fp, lane_block, inv_sigma_sq, inv_gamma);
  return static_cast<int>(cudaGetLastError());
}
