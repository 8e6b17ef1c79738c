// DCNv2 (modulated deformable 3x3 conv) forward as an implicit GEMM, for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel
// bevformer_tpu/kernels/dcn_pallas.py::_kernel_conv_rc (launched from
// _forward_conv via dcn_conv_pallas), which samples through windowed
// one-hot matmuls and clips vertical offsets to +-clip_y so that its windows
// stay small. The function is the exact path of
// bevformer_tpu/models/resnet.py::ModulatedDeformConv: sample at
// (oy*s - 1 + ky + dy, ox*s - 1 + kx + dx), bilinear, zeros outside the
// image, times the sigmoid mask, contracted with weight[9C, Cout]. There is
// no clip here: the card gathers directly.
//
// What bounds it on this card: the contraction. Per frame of bevformer_base
// the 26 DCN convs are about 1.07 TFLOP (M = 6*58*100 pixels, K = 9*256,
// N = 256 in stage 3; M = 6*29*50, K = 9*512, N = 512 in stage 4), against
// a few hundred MB of input reads. This first kernel runs the product on the
// fp32 SIMT units (no tensor cores), so arithmetic and shared-memory
// bandwidth bound it.
//
// What the design does about it: the im2col column [pixels, 9C] (nine times
// the feature map) never reaches device memory. Each 256-thread block owns
// a 64-pixel x 64-channel output tile. It first computes, for its 64 pixels
// and 9 taps, the four bilinear corner offsets and their weights (mask
// folded in) into shared memory. Then for each 32-deep K tile, which lies in
// one tap because C is a multiple of 32, it samples the [64, 32] slice of
// the column straight into shared memory (lane = channel, so each corner is
// one coalesced 128-byte read of the channels-last input), loads the
// [32, 64] weight tile, and accumulates a 4x4 register tile per thread in
// fp32. Tensor cores (wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // K tile (within one tap)
constexpr int TAPS = 9;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dcn_conv_fwd_kernel(const float* __restrict__ x,      // [B, H, W, C]
                    const float* __restrict__ off_y,  // [B, OH, OW, 9]
                    const float* __restrict__ off_x,  // [B, OH, OW, 9]
                    const float* __restrict__ mask,   // [B, OH, OW, 9]
                    const float* __restrict__ weight, // [9C, Cout]
                    float* __restrict__ out,          // [B, OH, OW, Cout]
                    int B, int H, int W, int C, int OH, int OW, int Cout,
                    int stride) {
  __shared__ float As[BM][BK + 1];  // sampled column tile, +1 against bank conflicts
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int s_idx[TAPS][4][BM];  // corner element offset into x, -1 if outside
  __shared__ float s_w[TAPS][4][BM];  // bilinear weight * mask

  const int M = B * OH * OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  for (int e = tid; e < TAPS * BM; e += THREADS) {
    const int t = e / BM;
    const int mi = e % BM;
    const int m = m0 + mi;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < M) {
      const int b = m / (OH * OW);
      const int r = m % (OH * OW);
      const int oy = r / OW;
      const int ox = r % OW;
      const int64_t o = (int64_t)m * TAPS + t;
      const float py = (float)(oy * stride - 1 + t / 3) + off_y[o];
      const float px = (float)(ox * stride - 1 + t % 3) + off_x[o];
      const float mk = mask[o];
      // every corner is outside unless -1 < py < H and -1 < px < W (NaN fails)
      if (py > -1.f && px > -1.f && py < (float)H && px < (float)W) {
        const float fy = floorf(py);
        const float fx = floorf(px);
        const int y0 = (int)fy;
        const int x0 = (int)fx;
        const float ty = py - fy;
        const float tx = px - fx;
        const float cw[4] = {(1.f - ty) * (1.f - tx), (1.f - ty) * tx,
                             ty * (1.f - tx), ty * tx};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int yy = y0 + (j >> 1);
          const int xx = x0 + (j & 1);
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            idx[j] = ((b * H + yy) * W + xx) * C;
            wt[j] = cw[j] * mk;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_idx[t][j][mi] = idx[j];
      s_w[t][j][mi] = wt[j];
    }
  }
  __syncthreads();

  const int tn = tid % 16;  // this thread's 4 output channels: tn*4 ..
  const int tm = tid / 16;  // this thread's 4 pixels: tm*4 ..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int Kdim = TAPS * C;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k0 = 0; k0 < Kdim; k0 += BK) {
    const int t = k0 / C;
    const int c = k0 % C + lane;
    // sample the [BM, BK] column tile: lane = channel, warp strides pixels
#pragma unroll
    for (int i = 0; i < BM / (THREADS / 32); ++i) {
      const int mi = warp + i * (THREADS / 32);
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int id = s_idx[t][j][mi];
        if (id >= 0) v += s_w[t][j][mi] * x[id + c];
      }
      As[mi][lane] = v;
    }
    // weight tile [BK, BN]
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int kr = tid / BN + i * (THREADS / BN);
      const int n = n0 + (tid % BN);
      Bs[kr][tid % BN] = n < Cout ? weight[(int64_t)(k0 + kr) * Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[tm * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a * bb[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < Cout) out[(int64_t)m * Cout + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int dcn_conv_fwd(const void* x, const void* off_y, const void* off_x,
                            const void* mask, const void* weight, void* out,
                            int B, int H, int W, int C, int OH, int OW,
                            int Cout, int stride, void* stream) {
  if (C % BK != 0 || stride < 1) return (int)cudaErrorInvalidValue;
  const int M = B * OH * OW;
  if (M == 0 || Cout == 0) return (int)cudaSuccess;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  dcn_conv_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<const float*>(weight), static_cast<float*>(out), B, H, W, C,
      OH, OW, Cout, stride);
  return (int)cudaGetLastError();
}
