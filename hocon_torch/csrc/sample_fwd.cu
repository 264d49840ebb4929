// K3: border-clamped bilinear sampler forward for Hopper (sm_90a).
//
// Replaces hocon/render/sample_pallas.py:_sample_kernel (launched by
// _sample_fwd_call). Same function as hocon/render/warp.py
// bilinear_sample_gather: coords minus 0.5, floor, the 2x2 anchor clamped
// to [0, W-2] x [0, H-2], fractions clamped to [0, 1], then the x-lerp and
// the y-lerp. The TPU kernel recast the gather as a hat-weight matmul
// because TPU gathers are slow; here it is the plain 4-tap gather, in f32.
//
// Bound on this card: bytes (read the coords and the four taps, write C
// floats; a few operations per byte). Design: one thread per output pixel
// computes all C channels from the NHWC image, so consecutive threads read
// consecutive coordinate pairs and write consecutive output pixels; the
// taps of neighbouring pixels mostly share cache lines in L1/L2.

#include <cuda_runtime.h>

namespace {

__global__ void sample_fwd_kernel(const float* __restrict__ image,   // (B, H, W, C)
                                  const float2* __restrict__ coords, // (B, Hq, Wq)
                                  float* __restrict__ out,           // (B, Hq, Wq, C)
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
  float* o = out + i * c;
  for (int ch = 0; ch < c; ++ch) {
    const float top = p00[ch] * (1.0f - fx) + p00[c + ch] * fx;
    const float bot = p10[ch] * (1.0f - fx) + p10[c + ch] * fx;
    o[ch] = top * (1.0f - fy) + bot * fy;
  }
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch.
extern "C" int hocon_sample_fwd(const float* image, const float* coords, float* out,
                                int b, int h, int w, int c, int hq, int wq,
                                void* stream) {
  const long long n = static_cast<long long>(b) * hq * wq;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  sample_fwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      image, reinterpret_cast<const float2*>(coords), out, n, hq * wq, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
