// DCNv2 modulated deformable im2col (K5), for Hopper (sm_90a).
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
// What bounds it on this card: bytes, and of them the column it writes:
// 320.7 MB of 360 MB at R101 stage 3 of bevformer_base ([6*58*100, 9*256]
// fp32). The input x (35.6 MB there) fits the 50 MB L2, so the four corner
// reads of each element should come from L2, not device memory.
//
// What the design does about it:
// - One block per BM output pixels. Phase 1 builds, once per (pixel, tap),
//   the four corners' offsets into x (-1 outside), their bilinear weights
//   and the mask, into shared memory: the index arithmetic and the three
//   loads of off_y, off_x and mask happen once per (pixel, tap), not once
//   per channel (as K2's tables, csrc/dcn_conv_fwd.cu, do). The bounds test
//   is the forward's: some corner lies inside iff -1 < py < H and -1 < px <
//   W.
// - Phase 2: one warp per (pixel, tap) row of C channels at a time; a lane
//   loads the four corners of 4 channels with 16-byte loads of the
//   channels-last x and writes them with one 16-byte store, so a warp moves
//   512 contiguous bytes per step. No index arithmetic per element, and no
//   64-bit division anywhere. The stores are streaming (__stcs, evict
//   first): the column passes through the L2 without pushing x out of it.
// - BM = 8 pixels (72 rows) per block: measured on an H100 at stage 3,
//   8, 16 and 32 pixels took 0.140, 0.152 and 0.205 ms a call with
//   streaming stores, 0.143, 0.164 and 0.226 with plain ones (more, smaller
//   blocks even out the last wave).
// - The arithmetic is the plain version's, operation for operation, with no
//   FMA: each corner times its weight, summed corner by corner in the order
//   (0,0), (0,1), (1,0), (1,1), then times the mask (__fmul_rn and
//   __fadd_rn keep nvcc from fusing them). So the column agrees with the
//   plain version's bitwise, wherever that one runs its elementwise ops
//   unfused (chip_smoke.py prints the share).
// - The C entry takes C a multiple of 4 and x and cols on 16-byte
//   boundaries (the float4 loads and stores); the model's caller, the DCN
//   backward, has C a multiple of 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;               // output pixels per block
constexpr int ROWS = BM * TAPS;     // (pixel, tap) rows per block

struct Tables {
  int4 idx[ROWS];   // float4 offset of each corner's channel 0 in x, -1 outside
  float4 w[ROWS];   // bilinear weight of each corner
  float mask[ROWS];
};

__device__ __forceinline__ float4 corner(const float4* __restrict__ x, int idx, int c) {
  return idx >= 0 ? __ldg(x + idx + c) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc + w * v, channel by channel, rounded after each operation
__device__ __forceinline__ float4 add_term(float4 acc, float w, float4 v) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)), __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                     __fadd_rn(acc.z, __fmul_rn(v.z, w)), __fadd_rn(acc.w, __fmul_rn(v.w, w)));
}

__global__ void __launch_bounds__(THREADS)
dcn_im2col_kernel(const float4* __restrict__ x,     // [B, H, W, C]
                  const float* __restrict__ off_y,  // [B, OH, OW, 9]
                  const float* __restrict__ off_x,  // [B, OH, OW, 9]
                  const float* __restrict__ mask,   // [B, OH, OW, 9]
                  float4* __restrict__ cols,        // [B*OH*OW, 9*C]
                  int B, int H, int W, int C, int OH, int OW, int stride) {
  __shared__ Tables s;
  const int M = B * OH * OW;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0) * TAPS;
  const int c4 = C / 4;  // float4s per row of x and per tap of a column row

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
    // every corner is outside unless -1 < py < H and -1 < px < W (NaN fails)
    if (py > -1.f && px > -1.f && py < (float)H && px < (float)W) {
      const float fy = floorf(py);
      const float fx = floorf(px);
      const int y0 = (int)fy;
      const int x0 = (int)fx;
      const float ty = py - fy;
      const float tx = px - fx;
      const int p00 = (b * H + y0) * W + x0;  // pixel of corner (0, 0)
      if (y0 >= 0 && x0 >= 0) { idx.x = p00 * c4; w.x = __fmul_rn(1.f - ty, 1.f - tx); }
      if (y0 >= 0 && x0 + 1 < W) { idx.y = (p00 + 1) * c4; w.y = __fmul_rn(1.f - ty, tx); }
      if (y0 + 1 < H && x0 >= 0) { idx.z = (p00 + W) * c4; w.z = __fmul_rn(ty, 1.f - tx); }
      if (y0 + 1 < H && x0 + 1 < W) { idx.w = (p00 + W + 1) * c4; w.w = __fmul_rn(ty, tx); }
    }
    s.idx[e] = idx;
    s.w[e] = w;
    s.mask[e] = mask[o];
  }
  __syncthreads();

  // phase 2: one warp per row; row e of the block is row m0 * 9 + e of cols
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* out = cols + (int64_t)m0 * TAPS * c4;
  for (int e = warp; e < rows; e += WARPS) {
    const int4 idx = s.idx[e];
    const float4 w = s.w[e];
    const float mk = s.mask[e];
    float4* orow = out + (int64_t)e * c4;
#pragma unroll 2
    for (int c = lane; c < c4; c += 32) {
      const float4 v00 = corner(x, idx.x, c);
      const float4 v01 = corner(x, idx.y, c);
      const float4 v10 = corner(x, idx.z, c);
      const float4 v11 = corner(x, idx.w, c);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx.x >= 0) acc = add_term(acc, w.x, v00);
      if (idx.y >= 0) acc = add_term(acc, w.y, v01);
      if (idx.z >= 0) acc = add_term(acc, w.z, v10);
      if (idx.w >= 0) acc = add_term(acc, w.w, v11);
      __stcs(orow + c, make_float4(__fmul_rn(acc.x, mk), __fmul_rn(acc.y, mk),
                                   __fmul_rn(acc.z, mk), __fmul_rn(acc.w, mk)));
    }
  }
}

}  // namespace

// The one check of the arguments: C a multiple of 4, stride at least 1, x
// and cols on 16-byte boundaries; anything else returns
// cudaErrorInvalidValue, which the wrapper raises.
extern "C" int dcn_im2col(const void* x, const void* off_y, const void* off_x,
                          const void* mask, void* cols, int B, int H, int W,
                          int C, int OH, int OW, int stride, void* stream) {
  if (C < 4 || C % 4 != 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)cols) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int64_t pixels = (int64_t)B * OH * OW;
  if (pixels == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((pixels + BM - 1) / BM);
  dcn_im2col_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<float4*>(cols), B, H, W, C, OH, OW, stride);
  return (int)cudaGetLastError();
}
