// JPEG decode and encode on the card through nvJPEG, with a plain C interface.
//
// Not the port of a TPU kernel: the reference reads frames on the host with
// cv2.imread (hocon/data/hand_dataset.py:_load_image), whose libjpeg-turbo
// upsamples the chroma planes with its "fancy" triangle filter and converts
// YCbCr to RGB in 16-bit fixed point. nvJPEG's own RGB output upsamples by
// replication and differs from it by up to 78 levels at colour edges. So
// nvJPEG decodes only to its planes (Y, Cb, Cr at their own resolution: the
// Huffman decode on the host, the inverse DCT on the card), and the kernel
// here, jpeg_ycc_rgb, does libjpeg-turbo's upsampling and conversion in its
// integer arithmetic, one thread per output pixel. What is left of the
// difference is nvJPEG's inverse DCT against libjpeg-turbo's (chip_smoke.py
// holds it to a bar). The kernel is bound by bytes: it reads the planes
// once and writes 3 bytes a pixel; its plain version is
// hocon_torch/data/images.py:ycc_to_rgb_plain.
//
// Built like the kernels by hocon_torch/utils/cuda_build.py, linked with
// -lnvjpeg. One context holds an nvJPEG handle, a decoder state and, made at
// the first encode, an encoder state and its parameters. A decoder state
// serves one thread at a time, so the wrapper keeps one context per thread.
//
// Every function returns 0 or an error code: an nvjpegStatus_t as it is, or
// 1000 + a cudaError_t where a CUDA call failed.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>

namespace {

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

int cuda_code(cudaError_t err) { return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err); }

}  // namespace

extern "C" int hocon_jpeg_open(void** out) {
  Context* ctx = new Context();
  int st = nvjpegCreateSimple(&ctx->handle);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(ctx->handle, &ctx->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (ctx->handle) nvjpegDestroy(ctx->handle);
    delete ctx;
    return st;
  }
  *out = ctx;
  return 0;
}

extern "C" int hocon_jpeg_close(void* p) {
  Context* ctx = static_cast<Context*>(p);
  if (ctx->params) nvjpegEncoderParamsDestroy(ctx->params);
  if (ctx->enc) nvjpegEncoderStateDestroy(ctx->enc);
  if (ctx->state) nvjpegJpegStateDestroy(ctx->state);
  int st = nvjpegDestroy(ctx->handle);
  delete ctx;
  return st;
}

// Component count, chroma subsampling (nvjpegChromaSubsampling_t) and each
// component's width and height (up to NVJPEG_MAX_COMPONENT = 4) of the JPEG
// in data[0:length], read from its header on the host.
extern "C" int hocon_jpeg_info(void* p, const unsigned char* data, size_t length, int* components,
                               int* subsampling, int* widths, int* heights) {
  Context* ctx = static_cast<Context*>(p);
  nvjpegChromaSubsampling_t css;
  int st = nvjpegGetImageInfo(ctx->handle, data, length, components, &css, widths, heights);
  *subsampling = static_cast<int>(css);
  return st;
}

// Decode data[0:length] into its planes in device memory, on stream: Y into
// y (rows of y_pitch bytes) and, unless cb is null (a grey JPEG), Cb and Cr at
// their own resolution into cb and cr (rows of c_pitch bytes). nvJPEG parses
// the bitstream on the host and runs the inverse DCT on the card.
extern "C" int hocon_jpeg_decode_planes(void* p, const unsigned char* data, size_t length,
                                        unsigned char* y, int y_pitch, unsigned char* cb,
                                        unsigned char* cr, int c_pitch, void* stream) {
  Context* ctx = static_cast<Context*>(p);
  nvjpegImage_t img = {};
  img.channel[0] = y;
  img.pitch[0] = static_cast<size_t>(y_pitch);
  if (cb) {
    img.channel[1] = cb;
    img.channel[2] = cr;
    img.pitch[1] = img.pitch[2] = static_cast<size_t>(c_pitch);
  }
  return nvjpegDecode(ctx->handle, ctx->state, data, length,
                      cb ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img,
                      static_cast<cudaStream_t>(stream));
}

namespace {

// libjpeg-turbo's fancy upsampling (jdsample.c h2v2_fancy_upsample and
// h2v1_fancy_upsample) of a chroma plane (cw x ch, rows of pitch bytes) at
// output pixel (x, y). Its first / last column and row cases are the general
// formula with the neighbour clamped to the plane (the row above the first
// is the first, as libjpeg's context rows are). Planes 2 columns wide or
// less are replicated, as libjpeg does.
__device__ __forceinline__ int upsample(const unsigned char* plane, int pitch, int cw, int ch,
                                        int hs, int vs, int x, int y) {
  const int cx = hs == 2 ? x >> 1 : x;
  const int cy = vs == 2 ? y >> 1 : y;
  const unsigned char* row = plane + static_cast<size_t>(cy) * pitch;
  if (hs == 1 || cw <= 2) return row[cx];
  const int side = (x & 1) ? min(cx + 1, cw - 1) : max(cx - 1, 0);
  if (vs == 1) return (3 * row[cx] + row[side] + ((x & 1) ? 2 : 1)) >> 2;
  const int far_y = (y & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
  const unsigned char* far_row = plane + static_cast<size_t>(far_y) * pitch;
  const int near = 3 * row[cx] + far_row[cx];
  const int next = 3 * row[side] + far_row[side];
  return (3 * near + next + ((x & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ unsigned char clamp255(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// libjpeg-turbo's jdcolor.c ycc_rgb_convert: 16-bit fixed point, FIX(1.402)
// = 91881, FIX(1.772) = 116130, FIX(0.71414) = 46802, FIX(0.34414) = 22554,
// ONE_HALF = 32768, arithmetic right shifts, clamped to [0, 255].
__global__ void jpeg_ycc_rgb(const unsigned char* __restrict__ y_plane, int y_pitch,
                             const unsigned char* __restrict__ cb_plane,
                             const unsigned char* __restrict__ cr_plane, int c_pitch, int cw,
                             int ch, int hs, int vs, unsigned char* __restrict__ out, int width,
                             int height) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width) return;
  const int luma = y_plane[static_cast<size_t>(y) * y_pitch + x];
  unsigned char* o = out + (static_cast<size_t>(y) * width + x) * 3;
  if (!cb_plane) {  // grey: three equal channels
    o[0] = o[1] = o[2] = static_cast<unsigned char>(luma);
    return;
  }
  const int cb = upsample(cb_plane, c_pitch, cw, ch, hs, vs, x, y) - 128;
  const int cr = upsample(cr_plane, c_pitch, cw, ch, hs, vs, x, y) - 128;
  o[0] = clamp255(luma + ((91881 * cr + 32768) >> 16));
  o[1] = clamp255(luma + ((-22554 * cb - 46802 * cr + 32768) >> 16));
  o[2] = clamp255(luma + ((116130 * cb + 32768) >> 16));
}

}  // namespace

// Interleaved RGB (width x height, rows of 3 * width bytes) at out from the
// planes hocon_jpeg_decode_planes wrote; cb null for a grey JPEG. hs, vs:
// the chroma planes' horizontal and vertical subsampling (1 or 2 each).
extern "C" int hocon_jpeg_ycc_rgb(const unsigned char* y, int y_pitch, const unsigned char* cb,
                                  const unsigned char* cr, int c_pitch, int cw, int ch, int hs,
                                  int vs, unsigned char* out, int width, int height,
                                  void* stream) {
  const int threads = 128;
  dim3 grid((width + threads - 1) / threads, height);
  jpeg_ycc_rgb<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_pitch, cb, cr, c_pitch, cw, ch, hs, vs, out, width, height);
  return cuda_code(cudaGetLastError());
}

// Encode interleaved RGB (device memory, width x height, rows of 3 * width
// bytes) as a baseline JPEG at quality 1-100, with 4:2:0 chroma subsampling
// or none (subsample_420 = 0, 4:4:4). Waits for stream and returns the
// bitstream's size in *length; hocon_jpeg_bitstream copies it out.
extern "C" int hocon_jpeg_encode(void* p, const unsigned char* rgb, int width, int height,
                                 int quality, int subsample_420, size_t* length, void* stream) {
  Context* ctx = static_cast<Context*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int st = NVJPEG_STATUS_SUCCESS;
  if (!ctx->enc) st = nvjpegEncoderStateCreate(ctx->handle, &ctx->enc, s);
  if (st == NVJPEG_STATUS_SUCCESS && !ctx->params)
    st = nvjpegEncoderParamsCreate(ctx->handle, &ctx->params, s);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncoderParamsSetQuality(ctx->params, quality, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetSamplingFactors(ctx->params,
                                               subsample_420 ? NVJPEG_CSS_420 : NVJPEG_CSS_444, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegImage_t src = {};
  src.channel[0] = const_cast<unsigned char*>(rgb);
  src.pitch[0] = static_cast<size_t>(3) * width;
  st = nvjpegEncodeImage(ctx->handle, ctx->enc, ctx->params, &src, NVJPEG_INPUT_RGBI, width,
                         height, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc, nullptr, length, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  return cuda_code(cudaStreamSynchronize(s));
}

// Copy the last encode's bitstream to out (host memory of *length bytes).
extern "C" int hocon_jpeg_bitstream(void* p, unsigned char* out, size_t* length, void* stream) {
  Context* ctx = static_cast<Context*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int st = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc, out, length, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  return cuda_code(cudaStreamSynchronize(s));
}
