// K3: border-clamped bilinear sampler forward for Hopper (sm_90a).
//
// Replaces hocon/render/sample_pallas.py:_sample_kernel (launched by
// _sample_fwd_call). Same function as hocon/render/warp.py
// bilinear_sample_gather: coords minus 0.5, floor, the 2x2 anchor clamped
// to [0, W-2] x [0, H-2], fractions clamped to [0, 1], then the x-lerp and
// the y-lerp. The TPU kernel recast the gather as a hat-weight matmul
// because TPU gathers are slow; here it is the plain 4-tap gather, in f32.
//
// Bound on this card: bytes. At the main path's shapes (16 views, a
// 256^2 x 3 image sampled at 256^2 coordinates) it reads the coordinates
// (8.4 MB) and the image (12.6 MB, each texel once if the taps of
// neighbouring queries share cache lines) and writes 12.6 MB: 33.6 MB,
// 0.0100 ms at 3.35 TB/s, against a handful of operations per byte.
//
// Design: a gather that streams. The batch is blockIdx.y, so all index
// math is 32-bit (no 64-bit division per thread). Each thread takes 4
// consecutive query pixels: two 16-byte loads of their 8 coordinates and
// C 16-byte stores of their 4 x C outputs, so a warp reads 1 KB and writes
// 32 x 16 x C bytes in whole lines. Each tap row's two neighbouring texels
// are 2C consecutive floats of the NHWC image, read through the read-only
// path; the 4 x 2 rows of a thread's queries are all in flight at once.
// Vector access needs the group's first pixel at a flat index (over batch
// and queries) that is a multiple of 4; when Hq * Wq is not, the few pixels
// of an image before its first such index and after its last whole group
// take one thread each (the head and tail), in the same kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;     // query pixels per thread on the vector path
constexpr int kThreads = 64;  // threads per block (256 queries): many small blocks
constexpr int kChannels = 3;  // image channels C the kernel is built for (RGB frames)

// One query pixel: all C channels, with sample_fwd_plain's clamps and lerp
// order.
template <int C>
__device__ __forceinline__ void sample_pixel(const float* __restrict__ img, int h, int w,
                                             float cx, float cy, float* v) {
  const float x = cx - 0.5f;
  const float y = cy - 0.5f;
  const int x0 = min(max(__float2int_rd(x), 0), w - 2);
  const int y0 = min(max(__float2int_rd(y), 0), h - 2);
  const float fx = fminf(fmaxf(x - static_cast<float>(x0), 0.0f), 1.0f);
  const float fy = fminf(fmaxf(y - static_cast<float>(y0), 0.0f), 1.0f);
  const float* p0 = img + (y0 * w + x0) * C;  // texels (y0, x0) and (y0, x0 + 1)
  const float* p1 = p0 + w * C;               // texels (y0 + 1, x0) and (y0 + 1, x0 + 1)
  float t[2 * C], u[2 * C];
#pragma unroll
  for (int i = 0; i < 2 * C; ++i) {
    t[i] = __ldg(p0 + i);
    u[i] = __ldg(p1 + i);
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float top = t[ch] * (1.0f - fx) + t[C + ch] * fx;
    const float bot = u[ch] * (1.0f - fx) + u[C + ch] * fx;
    v[ch] = top * (1.0f - fy) + bot * fy;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
sample_fwd_kernel(const float* __restrict__ image,   // (B, H, W, C)
                  const float* __restrict__ coords,  // (B, Hq, Wq, 2)
                  float* __restrict__ out,           // (B, Hq, Wq, C)
                  int per_image, int h, int w) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int first = b * per_image;  // flat index of the image's first query
  const int head = min((kGroup - first % kGroup) % kGroup, per_image);
  const int groups = (per_image - head) / kGroup;
  const int tail = per_image - head - groups * kGroup;
  const float* img = image + b * h * w * C;

  if (t < groups) {
    const int p = first + head + t * kGroup;  // a multiple of 4: 16-byte aligned
    const float4* cp = reinterpret_cast<const float4*>(coords + 2 * p);
    const float4 c01 = __ldg(cp);
    const float4 c23 = __ldg(cp + 1);
    float v[kGroup * C];
    sample_pixel<C>(img, h, w, c01.x, c01.y, v);
    sample_pixel<C>(img, h, w, c01.z, c01.w, v + C);
    sample_pixel<C>(img, h, w, c23.x, c23.y, v + 2 * C);
    sample_pixel<C>(img, h, w, c23.z, c23.w, v + 3 * C);
    float4* op = reinterpret_cast<float4*>(out + p * C);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      op[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else if (t < groups + head + tail) {
    const int i = t - groups;  // head pixels, then tail pixels
    const int p = first + (i < head ? i : head + groups * kGroup + (i - head));
    float v[C];
    sample_pixel<C>(img, h, w, __ldg(coords + 2 * p), __ldg(coords + 2 * p + 1), v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[p * C + ch] = v[ch];
  }
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch. Built for
// C = 3 channels; coords and out must be 16-byte aligned, and every flat
// offset (B * H * W * C, B * Hq * Wq * C) must fit in an int.
extern "C" int hocon_sample_fwd(const float* image, const float* coords, float* out,
                                int b, int h, int w, int c, int hq, int wq,
                                void* stream) {
  if (b > 65535 || c != kChannels) return static_cast<int>(cudaErrorInvalidValue);
  const int per_image = hq * wq;
  if (b == 0 || per_image == 0) return 0;
  // Vector threads, plus up to 3 head and 3 tail pixels.
  const int threads = per_image / kGroup + 2 * (kGroup - 1);
  const dim3 grid((threads + kThreads - 1) / kThreads, b);
  sample_fwd_kernel<kChannels><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      image, coords, out, per_image, h, w);
  return static_cast<int>(cudaGetLastError());
}
