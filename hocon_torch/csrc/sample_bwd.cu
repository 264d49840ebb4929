// K4: border-clamped bilinear sampler backward for Hopper (sm_90a).
//
// Replaces hocon/render/sample_pallas.py:_sample_bwd_kernel (launched by
// _sample_bwd). Same function: the gradient of K3's output with respect to
// the coordinates only (the image is data). With x = coord_x - 0.5, the
// anchor x0 = clamp(floor(x), 0, W-2) and the y-lerped columns
// rows_c[k] = (1 - fy) * img[y0, k, c] + fy * img[y0 + 1, k, c]:
//   gx = sum_c g_c * (rows_c[x0 + 1] - rows_c[x0]),
//   gy = sum_c g_c * ((1 - fx) * (img[y0+1, x0] - img[y0, x0])
//                     + fx * (img[y0+1, x0+1] - img[y0, x0+1]))[c].
// At integer coordinates that is the right-hand slope (the TPU kernel's
// sign(0) := -1), and a coordinate outside the open interval (0, W-1)
// (resp. (0, H-1)) was clamped and gets 0, as the strict in_rng mask does.
//
// Bound on this card: bytes (read the coords, the C cotangents and four
// taps, write two floats; a few operations per byte). Design: one thread
// per query pixel, as K3, so consecutive threads read consecutive
// coordinate pairs and cotangents and write consecutive (gx, gy) pairs.

#include <cuda_runtime.h>

namespace {

__global__ void sample_bwd_kernel(const float* __restrict__ image,    // (B, H, W, C)
                                  const float2* __restrict__ coords,  // (B, Hq, Wq)
                                  const float* __restrict__ g,        // (B, Hq, Wq, C)
                                  float2* __restrict__ dcoords,       // (B, Hq, Wq)
                                  long long n, int per_image, int h, int w, int c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int bi = static_cast<int>(i / per_image);
  const float2 xy = coords[i];
  const float x = xy.x - 0.5f;
  const float y = xy.y - 0.5f;
  const int x0 = min(max(__float2int_rd(x), 0), w - 2);
  const int y0 = min(max(__float2int_rd(y), 0), h - 2);
  const float fx = fminf(fmaxf(x - static_cast<float>(x0), 0.0f), 1.0f);
  const float fy = fminf(fmaxf(y - static_cast<float>(y0), 0.0f), 1.0f);
  const float* p00 = image + ((static_cast<size_t>(bi) * h + y0) * w + x0) * c;
  const float* p10 = p00 + static_cast<size_t>(w) * c;
  const float* gq = g + i * c;
  float gx = 0.0f, gy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = p00[ch], v01 = p00[c + ch];
    const float v10 = p10[ch], v11 = p10[c + ch];
    const float gc = gq[ch];
    const float r0 = v00 * (1.0f - fy) + v10 * fy;
    const float r1 = v01 * (1.0f - fy) + v11 * fy;
    gx += gc * (r1 - r0);
    gy += gc * ((v10 - v00) * (1.0f - fx) + (v11 - v01) * fx);
  }
  const bool x_in = x > 0.0f && x < static_cast<float>(w - 1);
  const bool y_in = y > 0.0f && y < static_cast<float>(h - 1);
  dcoords[i] = make_float2(x_in ? gx : 0.0f, y_in ? gy : 0.0f);
}

}  // namespace

// Launches K4 on `stream`; returns the cudaError_t of the launch.
extern "C" int hocon_sample_bwd(const float* image, const float* coords, const float* g,
                                float* dcoords, int b, int h, int w, int c, int hq, int wq,
                                void* stream) {
  const long long n = static_cast<long long>(b) * hq * wq;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  sample_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      image, reinterpret_cast<const float2*>(coords), g,
      reinterpret_cast<float2*>(dcoords), n, hq * wq, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
