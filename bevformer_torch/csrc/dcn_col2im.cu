// DCNv2 sampling backward (col2im and col2im_coord), for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels bevformer_tpu/kernels/msda_pallas.py::
// _bwd_aux_kernel and _bwd_dval_kernel (launched from _backward), which
// bevformer_tpu/kernels/dcn_pallas.py::_bwd calls with the DCN sampling
// recast as single-level msda (items = (pixel, tap), heads = C/32, p = 1)
// so that the TPU's windowed matmuls can scatter. Here it is written as the
// DCN backward itself, with the semantics of mmcv's
// modulated_deformable_col2im (dx) and modulated_deformable_col2im_coord
// (d offsets, d mask): given dcols = d(loss)/d(cols) of
// csrc/dcn_im2col.cu's column, for output pixel m and tap t sampling at
// (py, px) with corner weights w.. over the in-bounds corners v..,
//   dx[corner, c]  += dcols[m, t*C + c] * mask * w_corner
//   dmask[m, t]     = sum_c dcols * bilinear(x)
//   doff_y[m, t]    = mask * sum_c dcols * ((1-tx)(v10-v00) + tx(v11-v01))
//   doff_x[m, t]    = mask * sum_c dcols * ((1-ty)(v01-v00) + ty(v11-v10))
// There is no clip, so no clip mask on doff_y either.
//
// What bounds it on this card: bytes and atomics. Per (pixel, tap) it
// reads C floats of dcols and 4 x C of x, and adds 4 x C floats into dx;
// neighbouring pixels and taps hit the same corners, so the L2's atomic
// throughput is the limit.
//
// What the design does about it: one warp per (pixel, tap), lane =
// channel, so every read of dcols and x and every atomic add into dx is one
// coalesced 128-byte row of the channels-last layouts. The three sums over
// C are warp reductions (__shfl_xor_sync). dx is scattered with atomicAdd,
// so its last bits depend on the order the warps run in: it is not bitwise
// deterministic from run to run (nor is autograd's scatter on the plain
// version).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dcn_col2im_kernel(const float* __restrict__ x,      // [B, H, W, C]
                  const float* __restrict__ off_y,  // [B, OH, OW, 9]
                  const float* __restrict__ off_x,  // [B, OH, OW, 9]
                  const float* __restrict__ mask,   // [B, OH, OW, 9]
                  const float* __restrict__ dcols,  // [B*OH*OW, 9*C]
                  float* __restrict__ dx,           // [B, H, W, C], zeroed
                  float* __restrict__ doff_y,       // [B, OH, OW, 9]
                  float* __restrict__ doff_x,       // [B, OH, OW, 9]
                  float* __restrict__ dmask,        // [B, OH, OW, 9]
                  int B, int H, int W, int C, int OH, int OW, int stride) {
  const int64_t mt = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (mt >= (int64_t)B * OH * OW * TAPS) return;  // whole warps leave together
  const int t = (int)(mt % TAPS);
  const int64_t m = mt / TAPS;
  const int b = (int)(m / ((int64_t)OH * OW));
  const int r = (int)(m % ((int64_t)OH * OW));
  const int oy = r / OW;
  const int ox = r % OW;
  const float py = (float)(oy * stride - 1 + t / 3) + off_y[mt];
  const float px = (float)(ox * stride - 1 + t % 3) + off_x[mt];
  // some corner lies inside iff -1 <= py < H and -1 <= px < W (NaN fails);
  // at py == -1 the sample is 0 but its slope is not
  if (!(py >= -1.f && px >= -1.f && py < (float)H && px < (float)W)) {
    if (lane == 0) {
      doff_y[mt] = 0.f;
      doff_x[mt] = 0.f;
      dmask[mt] = 0.f;
    }
    return;
  }
  const float fy = floorf(py);
  const float fx = floorf(px);
  const int y0 = (int)fy;
  const int x0 = (int)fx;
  const float ty = py - fy;
  const float tx = px - fx;
  const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < H;
  const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < W;
  const float mk = mask[mt];
  const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
  const float w10 = ty * (1.f - tx), w11 = ty * tx;
  const int64_t o00 = (((int64_t)b * H + y0) * W + x0) * C;
  const int64_t o01 = o00 + C;
  const int64_t o10 = o00 + (int64_t)W * C;
  const int64_t o11 = o10 + C;
  const float* gp = dcols + mt * C;  // == m * 9C + t * C
  float s_m = 0.f, s_y = 0.f, s_x = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float g = gp[c];
    const float v00 = (in_y0 && in_x0) ? x[o00 + c] : 0.f;
    const float v01 = (in_y0 && in_x1) ? x[o01 + c] : 0.f;
    const float v10 = (in_y1 && in_x0) ? x[o10 + c] : 0.f;
    const float v11 = (in_y1 && in_x1) ? x[o11 + c] : 0.f;
    s_m += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
    s_y += g * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
    s_x += g * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
    const float gm = g * mk;
    if (in_y0 && in_x0) atomicAdd(dx + o00 + c, w00 * gm);
    if (in_y0 && in_x1) atomicAdd(dx + o01 + c, w01 * gm);
    if (in_y1 && in_x0) atomicAdd(dx + o10 + c, w10 * gm);
    if (in_y1 && in_x1) atomicAdd(dx + o11 + c, w11 * gm);
  }
  s_m = warp_sum(s_m);
  s_y = warp_sum(s_y);
  s_x = warp_sum(s_x);
  if (lane == 0) {
    dmask[mt] = s_m;
    doff_y[mt] = mk * s_y;
    doff_x[mt] = mk * s_x;
  }
}

}  // namespace

// dx must be zeroed by the caller (the kernel adds into it).
extern "C" int dcn_col2im(const void* x, const void* off_y, const void* off_x,
                          const void* mask, const void* dcols, void* dx,
                          void* doff_y, void* doff_x, void* dmask, int B,
                          int H, int W, int C, int OH, int OW, int stride,
                          void* stream) {
  if (C < 1 || stride < 1) return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t)B * OH * OW * TAPS;
  if (items == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dcn_col2im_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<const float*>(dcols), static_cast<float*>(dx),
      static_cast<float*>(doff_y), static_cast<float*>(doff_x),
      static_cast<float*>(dmask), B, H, W, C, OH, OW, stride);
  return (int)cudaGetLastError();
}
