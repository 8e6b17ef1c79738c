// DCNv2 modulated deformable im2col, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel bevformer_tpu/kernels/dcn_pallas.py::
// _kernel (launched from _forward), which builds the same column through
// windowed one-hot matmuls with vertical offsets clipped to +-clip_y. The
// JAX DCN backward (_conv_bwd) reruns it to get dWeight = cols^T g, as the
// port's backward does. The function is the sampling of
// bevformer_tpu/models/resnet.py::ModulatedDeformConv's exact path: for
// output pixel m = (b, oy, ox) and tap t = (ky, kx),
//   cols[m, t*C + c] = mask[m, t] * bilinear(x[b, :, :, c],
//                        oy*s - 1 + ky + off_y[m, t], ox*s - 1 + kx + off_x[m, t])
// with zeros outside the image. Rows are tap-major, as weight[9C, Cout]'s
// rows are. There is no clip here.
//
// What bounds it on this card: bytes. It reads 4 corners and writes one
// float per element of a [B*OH*OW, 9C] column (320 MB at R101 stage 3 of
// bevformer_base), with no arithmetic to speak of.
//
// What the design does about it: one thread per column element, channel
// fastest, so a warp reads each corner as one coalesced 128-byte row of
// the channels-last input and writes 128 contiguous bytes. The threads of a
// (pixel, tap) recompute its corners from the same three broadcast loads;
// that is cheaper than a table in shared memory at these sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dcn_im2col_kernel(const float* __restrict__ x,      // [B, H, W, C]
                  const float* __restrict__ off_y,  // [B, OH, OW, 9]
                  const float* __restrict__ off_x,  // [B, OH, OW, 9]
                  const float* __restrict__ mask,   // [B, OH, OW, 9]
                  float* __restrict__ cols,         // [B*OH*OW, 9*C]
                  int B, int H, int W, int C, int OH, int OW, int stride) {
  const int64_t total = (int64_t)B * OH * OW * TAPS * C;
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % C);
  const int64_t mt = e / C;  // m * 9 + t
  const int t = (int)(mt % TAPS);
  const int64_t m = mt / TAPS;
  const int b = (int)(m / ((int64_t)OH * OW));
  const int r = (int)(m % ((int64_t)OH * OW));
  const int oy = r / OW;
  const int ox = r % OW;
  const float py = (float)(oy * stride - 1 + t / 3) + off_y[mt];
  const float px = (float)(ox * stride - 1 + t % 3) + off_x[mt];
  float v = 0.f;
  // every corner is outside unless -1 < py < H and -1 < px < W (NaN fails)
  if (py > -1.f && px > -1.f && py < (float)H && px < (float)W) {
    const float fy = floorf(py);
    const float fx = floorf(px);
    const int y0 = (int)fy;
    const int x0 = (int)fx;
    const float ty = py - fy;
    const float tx = px - fx;
    const float* xb = x + (int64_t)b * H * W * C + c;
    if (y0 >= 0) {
      if (x0 >= 0) v += (1.f - ty) * (1.f - tx) * xb[((int64_t)y0 * W + x0) * C];
      if (x0 + 1 < W) v += (1.f - ty) * tx * xb[((int64_t)y0 * W + x0 + 1) * C];
    }
    if (y0 + 1 < H) {
      if (x0 >= 0) v += ty * (1.f - tx) * xb[((int64_t)(y0 + 1) * W + x0) * C];
      if (x0 + 1 < W) v += ty * tx * xb[((int64_t)(y0 + 1) * W + x0 + 1) * C];
    }
    v *= mask[mt];
  }
  cols[e] = v;  // e == m * 9C + t * C + c
}

}  // namespace

extern "C" int dcn_im2col(const void* x, const void* off_y, const void* off_x,
                          const void* mask, void* cols, int B, int H, int W,
                          int C, int OH, int OW, int stride, void* stream) {
  if (C < 1 || stride < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * OH * OW * TAPS * C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  dcn_im2col_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<float*>(cols), B, H, W, C, OH, OW, stride);
  return (int)cudaGetLastError();
}
