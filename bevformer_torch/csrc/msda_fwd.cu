// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel bevformer_tpu/kernels/msda_hi.py::_kernel_hi
// (launched from _forward_hi and _forward_hi_lw), which computes the op as
// windowed multi-hot matmuls because the TPU has no fast gather. The
// function is bevformer_tpu/kernels/msda.py::ms_deform_attn_jnp: for each
// (b, q, h) sum over (level, point) of attw * bilinear(value_l, loc), with
// pixel = loc * size - 0.5 (grid_sample, align_corners=False) and zeros
// outside the map, accumulated in fp32.
//
// What bounds it on this card: gathers. Each (b, q, h) reads 4 corners x
// L x P rows of D floats from a value map that is scattered in memory; it
// does 2 flops per byte read, far below the card's compute, so the kernel
// is bound by the latency and bandwidth of those reads (L2 holds most of
// the value map at the path's shapes).
//
// What the design does about it: one warp per (b, q, h) with lane = channel
// d, so each bilinear corner is one coalesced 128-byte read of
// value[b, k, h, 0:32] in the [B, K, H, D] layout. There are no windows and
// no sort: the card gathers directly, so the op is exact for any offsets.
// All lanes read the same location and weight (a broadcast load). Many warps
// in flight hide the read latency. No shared memory, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_kernel(const float* __restrict__ value,  // [B, K, H, D]
                const float* __restrict__ loc,    // [B, Q, H, L, P, 2]
                const float* __restrict__ attw,   // [B, Q, H, L, P]
                float* __restrict__ out,          // [B, Q, H, D]
                int B, int K, int Q, int H, int D, int L, int P,
                Levels lv) {
  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (int64_t)B * Q * H) return;
  const int h = (int)(item % H);
  const int b = (int)(item / ((int64_t)H * Q));
  const float* lp = loc + item * L * P * 2;
  const float* ap = attw + item * L * P;
  const int64_t row = (int64_t)H * D;  // stride between value pixels

  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int hh = lv.h[l];
      const int ww = lv.w[l];
      const float* vb = value + ((int64_t)b * K + lv.start[l]) * row + (int64_t)h * D + d;
      for (int p = 0; p < P; ++p) {
        // __fmul_rn keeps the product out of an FMA, so the pixel position
        // rounds as in the plain version (at x ~ 200 one ulp of an fp32
        // position is 1.5e-5 px)
        const float x = __fmul_rn(lp[(l * P + p) * 2], (float)ww) - 0.5f;
        const float y = __fmul_rn(lp[(l * P + p) * 2 + 1], (float)hh) - 0.5f;
        // all four corners lie outside unless -1 < x < ww and -1 < y < hh
        // (NaN fails too)
        if (!(x > -1.f && y > -1.f && x < (float)ww && y < (float)hh)) continue;
        const float fx = floorf(x);
        const float fy = floorf(y);
        const int x0 = (int)fx;
        const int y0 = (int)fy;
        const float tx = x - fx;
        const float ty = y - fy;
        float v = 0.f;
        if (y0 >= 0) {
          const float* r = vb + (int64_t)y0 * ww * row;
          if (x0 >= 0) v += (1.f - tx) * (1.f - ty) * r[(int64_t)x0 * row];
          if (x0 + 1 < ww) v += tx * (1.f - ty) * r[(int64_t)(x0 + 1) * row];
        }
        if (y0 + 1 < hh) {
          const float* r = vb + (int64_t)(y0 + 1) * ww * row;
          if (x0 >= 0) v += (1.f - tx) * ty * r[(int64_t)x0 * row];
          if (x0 + 1 < ww) v += tx * ty * r[(int64_t)(x0 + 1) * row];
        }
        acc += ap[l * P + p] * v;
      }
    }
    out[item * D + d] = acc;
  }
}

}  // namespace

extern "C" int msda_fwd(const void* value, const void* loc, const void* attw,
                        void* out, const void* level_hw, int L, int B, int K,
                        int Q, int H, int D, int P, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  const int* hw = static_cast<const int*>(level_hw);
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  const int64_t items = (int64_t)B * Q * H;
  if (items == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<float*>(out), B, K, Q, H, D,
      L, P, lv);
  return (int)cudaGetLastError();
}
