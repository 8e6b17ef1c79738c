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
// reads C floats of dcols (once: 320.7 MB at R101 stage 3 of
// bevformer_base) and 4 x C of x (35.6 MB there, in L2), and adds 4 x C
// floats into dx; neighbouring pixels and taps hit the same corners, so the
// L2's atomic throughput is the limit.
//
// What the design does about it (K5's structure, csrc/dcn_im2col.cu):
// - One block per BM = 8 output pixels. Phase 1 builds, once per (pixel,
//   tap), the four corners' float4 offsets into x and dx (-1 outside),
//   their bilinear weights, the fractional parts ty and tx, and the mask,
//   into shared memory: the index arithmetic and the loads of off_y, off_x
//   and mask happen once per (pixel, tap), with no 64-bit division. The
//   bounds test is the backward's: the sample counts iff -1 <= py < H and
//   -1 <= px < W, so at py == -1 the row-0 corners carry weight 0 and their
//   slope.
// - Phase 2: one warp per (pixel, tap) row of C channels; a lane takes 4
//   channels at a time with 16-byte loads of the four corners of x and a
//   streaming 16-byte load of dcols (__ldcs, evict first: it is read once),
//   and adds into dx with 16-byte vector atomics (atomicAdd(float4*),
//   REDG.E.ADD.F32x4): 8 atomic instructions per 128-byte corner row
//   instead of 32 scalar ones.
// - The three channel sums go through the warp's shuffles in a fixed order
//   and lane 0 writes them: d offsets and dmask are deterministic. dx is
//   scattered with atomics, so its last bits depend on the order the warps
//   run in: it is not bitwise deterministic from run to run (nor is
//   autograd's scatter on the plain version).
// - The C entry takes C a multiple of 4 and x, dcols and dx on 16-byte
//   boundaries (the float4 loads and atomics); the model's caller, the DCN
//   backward, has C a multiple of 32.
//
// bf16 (`dcn_col2im_bf16`, the counterpart of dcn_pallas._bwd at
// compute_dtype=bfloat16: the backward of the sampling of a bf16 x): the
// same body on a bf16 x, read 4 channels a lane by one 8-byte load of each
// corner, widened to fp32 exactly. dcols stays fp32: it is the fp32 product
// g W^T of the DCN backward (kernels/dcn.py::_DCNConv), as the JAX
// backward's dsampled is. dx is summed in an fp32 workspace with the same
// vector atomics (bf16 atomics would round every partial sum), which the
// wrapper rounds to bf16 once; d offsets and dmask are fp32. x on 8-byte
// boundaries, dcols and dx on 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_vec4.cuh"

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;            // output pixels per block
constexpr int ROWS = BM * TAPS;  // (pixel, tap) rows per block

struct Tables {
  int4 idx[ROWS];   // element offset of each corner's channel 0 in x and dx, -1 outside
  float4 w[ROWS];   // bilinear weight of each corner
  float4 tym[ROWS];  // ty, tx, mask, and 1 where the sample counts (else 0)
};

template <typename T>
__device__ __forceinline__ float4 corner(const T* __restrict__ x, int idx, int c) {
  return idx >= 0 ? ldg4(x + idx + c) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void red4(float* p, float w, float4 g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: float (dcn_col2im) or __nv_bfloat16 (dcn_col2im_bf16), x's
template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_col2im_kernel(const T* __restrict__ x,           // [B, H, W, C]
                  const float* __restrict__ off_y,   // [B, OH, OW, 9]
                  const float* __restrict__ off_x,   // [B, OH, OW, 9]
                  const float* __restrict__ mask,    // [B, OH, OW, 9]
                  const float* __restrict__ dcols,   // [B*OH*OW, 9*C]
                  float* __restrict__ dx,            // [B, H, W, C], zeroed
                  float* __restrict__ doff_y,        // [B, OH, OW, 9]
                  float* __restrict__ doff_x,        // [B, OH, OW, 9]
                  float* __restrict__ dmask,         // [B, OH, OW, 9]
                  int B, int H, int W, int C, int OH, int OW, int stride) {
  __shared__ Tables s;
  const int M = B * OH * OW;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0) * TAPS;

  // phase 1: the tables, one (pixel, tap) per thread at a time
  for (int e = threadIdx.x; e < rows; e += THREADS) {
    const int mi = e / TAPS;
    const int t = e - mi * TAPS;
    const int m = m0 + mi;
    const int b = m / (OH * OW);
    const int r = m - b * (OH * OW);
    const int oy = r / OW;
    const int ox = r - oy * OW;
    const int o = m * TAPS + t;
    const float py = (float)(oy * stride - 1 + t / 3) + off_y[o];
    const float px = (float)(ox * stride - 1 + t % 3) + off_x[o];
    int4 idx = make_int4(-1, -1, -1, -1);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 tym = make_float4(0.f, 0.f, mask[o], 0.f);
    // some corner lies inside iff -1 <= py < H and -1 <= px < W (NaN fails);
    // at py == -1 the sample is 0 but its slope is not
    if (py >= -1.f && px >= -1.f && py < (float)H && px < (float)W) {
      const float fy = floorf(py);
      const float fx = floorf(px);
      const int y0 = (int)fy;
      const int x0 = (int)fx;
      const float ty = py - fy;
      const float tx = px - fx;
      const int p00 = (b * H + y0) * W + x0;  // pixel of corner (0, 0)
      if (y0 >= 0 && x0 >= 0) { idx.x = p00 * C; w.x = (1.f - ty) * (1.f - tx); }
      if (y0 >= 0 && x0 + 1 < W) { idx.y = (p00 + 1) * C; w.y = (1.f - ty) * tx; }
      if (y0 + 1 < H && x0 >= 0) { idx.z = (p00 + W) * C; w.z = ty * (1.f - tx); }
      if (y0 + 1 < H && x0 + 1 < W) { idx.w = (p00 + W + 1) * C; w.w = ty * tx; }
      tym = make_float4(ty, tx, tym.z, 1.f);
    }
    s.idx[e] = idx;
    s.w[e] = w;
    s.tym[e] = tym;
  }
  __syncthreads();

  // phase 2: one warp per row; row e of the block is row m0 * 9 + e of dcols
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int e = warp; e < rows; e += WARPS) {
    const int64_t mt = (int64_t)m0 * TAPS + e;
    const float4 tym = s.tym[e];
    if (tym.w == 0.f) {  // no corner counts: every gradient of the row is 0
      if (lane == 0) doff_y[mt] = doff_x[mt] = dmask[mt] = 0.f;
      continue;
    }
    const int4 idx = s.idx[e];
    const float4 w = s.w[e];
    const float ty = tym.x, tx = tym.y, mk = tym.z;
    const float* grow = dcols + mt * C;
    float s_m = 0.f, s_y = 0.f, s_x = 0.f;
#pragma unroll 2
    for (int c = 4 * lane; c < C; c += 4 * 32) {
      const float4 g = __ldcs(reinterpret_cast<const float4*>(grow + c));
      const float4 v00 = corner(x, idx.x, c);
      const float4 v01 = corner(x, idx.y, c);
      const float4 v10 = corner(x, idx.z, c);
      const float4 v11 = corner(x, idx.w, c);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float a00[4] = {v00.x, v00.y, v00.z, v00.w};
      const float a01[4] = {v01.x, v01.y, v01.z, v01.w};
      const float a10[4] = {v10.x, v10.y, v10.z, v10.w};
      const float a11[4] = {v11.x, v11.y, v11.z, v11.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_m += gv[k] * (w.x * a00[k] + w.y * a01[k] + w.z * a10[k] + w.w * a11[k]);
        s_y += gv[k] * ((1.f - tx) * (a10[k] - a00[k]) + tx * (a11[k] - a01[k]));
        s_x += gv[k] * ((1.f - ty) * (a01[k] - a00[k]) + ty * (a11[k] - a10[k]));
      }
      const float4 gm = make_float4(g.x * mk, g.y * mk, g.z * mk, g.w * mk);
      if (idx.x >= 0) red4(dx + idx.x + c, w.x, gm);
      if (idx.y >= 0) red4(dx + idx.y + c, w.y, gm);
      if (idx.z >= 0) red4(dx + idx.z + c, w.z, gm);
      if (idx.w >= 0) red4(dx + idx.w + c, w.w, gm);
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
}

// dx (fp32) must be zeroed by the caller (the kernel adds into it). The one
// check of the arguments: C a multiple of 4, stride at least 1, x on a
// 4-element (16-byte fp32, 8-byte bf16) boundary, dcols and dx on 16-byte
// ones; anything else returns cudaErrorInvalidValue, which the wrapper
// raises.
template <typename T>
int launch_col2im(const void* x, const void* off_y, const void* off_x, const void* mask,
                  const void* dcols, void* dx, void* doff_y, void* doff_x, void* dmask, int B,
                  int H, int W, int C, int OH, int OW, int stride, void* stream) {
  if (C < 4 || C % 4 != 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % (4 * sizeof(T)) != 0 || ((uintptr_t)dcols | (uintptr_t)dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t pixels = (int64_t)B * OH * OW;
  if (pixels == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((pixels + BM - 1) / BM);
  dcn_col2im_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<const float*>(dcols), static_cast<float*>(dx),
      static_cast<float*>(doff_y), static_cast<float*>(doff_x),
      static_cast<float*>(dmask), B, H, W, C, OH, OW, stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dcn_col2im(const void* x, const void* off_y, const void* off_x,
                          const void* mask, const void* dcols, void* dx,
                          void* doff_y, void* doff_x, void* dmask, int B,
                          int H, int W, int C, int OH, int OW, int stride,
                          void* stream) {
  return launch_col2im<float>(x, off_y, off_x, mask, dcols, dx, doff_y, doff_x, dmask, B, H, W,
                              C, OH, OW, stride, stream);
}

// dcn_col2im on a bf16 x (dcols, the dx workspace, d offsets and dmask fp32)
extern "C" int dcn_col2im_bf16(const void* x, const void* off_y, const void* off_x,
                               const void* mask, const void* dcols, void* dx,
                               void* doff_y, void* doff_x, void* dmask, int B,
                               int H, int W, int C, int OH, int OW, int stride,
                               void* stream) {
  return launch_col2im<__nv_bfloat16>(x, off_y, off_x, mask, dcols, dx, doff_y, doff_x, dmask,
                                      B, H, W, C, OH, OW, stride, stream);
}
