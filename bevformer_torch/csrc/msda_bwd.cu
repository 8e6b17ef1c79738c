// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels
// bevformer_tpu/kernels/msda_hi.py::_bwd_aux_kernel_hi (dLoc, dAttw) and
// _bwd_dval_kernel_hi (dValue), launched from _backward_hi, which run the
// backward of the windowed forward as transposed multi-hot matmuls. The
// function is the gradient of bevformer_tpu/kernels/msda.py::
// ms_deform_attn_jnp, as autograd takes it through
// bevformer_torch/kernels/msda.py::ms_deform_attn_plain: for each
// (b, q, h, level, point) with pixel (x, y) = loc * (w, h) - 0.5, corner
// weights w00 = (1-tx)(1-ty), w01 = tx(1-ty), w10 = (1-tx)ty, w11 = tx*ty
// over the in-bounds corners v.., and g = grad_out[b, q, h, :]:
//   dAttw        = <g, sample>
//   dLoc.x       = attw * <g, (1-ty)(v01-v00) + ty(v11-v10)> * w
//   dLoc.y       = attw * <g, (1-tx)(v10-v00) + tx(v11-v01)> * h
//   dValue[corner] += attw * w_corner * g
//
// What bounds it on this card: the same scattered reads as the forward
// (4 corners x L x P rows of D floats per (b, q, h)), plus as many fp32
// atomic adds into dValue; a few flops per byte, so memory latency and the
// L2's atomic throughput bound it.
//
// What the design does about it: the forward's mapping, one warp per
// (b, q, h) with lane = channel d, so each corner read and each corner's
// atomic add is one coalesced 128-byte row of value[b, k, h, 0:32]. The
// pixel position is computed exactly as csrc/msda_fwd.cu does (__fmul_rn
// keeps loc * size out of an FMA), so forward and backward pick the same
// corners. dAttw, dLoc.x and dLoc.y are warp reductions (__shfl_xor_sync)
// over the channels. dValue is scattered with atomicAdd, so its last bits
// depend on the order the warps run in: it is not bitwise deterministic
// from run to run (nor is autograd's scatter on the plain version).

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_kernel(const float* __restrict__ value,     // [B, K, H, D]
                const float* __restrict__ loc,       // [B, Q, H, L, P, 2]
                const float* __restrict__ attw,      // [B, Q, H, L, P]
                const float* __restrict__ grad_out,  // [B, Q, H, D]
                float* __restrict__ dvalue,          // [B, K, H, D], zeroed
                float* __restrict__ dloc,            // [B, Q, H, L, P, 2]
                float* __restrict__ dattw,           // [B, Q, H, L, P]
                int B, int K, int Q, int H, int D, int L, int P,
                Levels lv) {
  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (int64_t)B * Q * H) return;  // whole warps leave together
  const int h = (int)(item % H);
  const int b = (int)(item / ((int64_t)H * Q));
  const float* lp = loc + item * L * P * 2;
  const float* ap = attw + item * L * P;
  const float* gp = grad_out + item * D;
  float* dlp = dloc + item * L * P * 2;
  float* dap = dattw + item * L * P;
  const int64_t row = (int64_t)H * D;  // stride between value pixels

  for (int l = 0; l < L; ++l) {
    const int hh = lv.h[l];
    const int ww = lv.w[l];
    const int64_t base = ((int64_t)b * K + lv.start[l]) * row + (int64_t)h * D;
    for (int p = 0; p < P; ++p) {
      const int lpi = l * P + p;
      const float x = __fmul_rn(lp[lpi * 2], (float)ww) - 0.5f;
      const float y = __fmul_rn(lp[lpi * 2 + 1], (float)hh) - 0.5f;
      // some corner lies inside iff -1 <= x < ww and -1 <= y < hh (NaN
      // fails); at x == -1 the sample is 0 but its slope is not
      if (!(x >= -1.f && y >= -1.f && x < (float)ww && y < (float)hh)) {
        if (lane == 0) {
          dap[lpi] = 0.f;
          dlp[lpi * 2] = 0.f;
          dlp[lpi * 2 + 1] = 0.f;
        }
        continue;
      }
      const float fx = floorf(x);
      const float fy = floorf(y);
      const int x0 = (int)fx;
      const int y0 = (int)fy;
      const float tx = x - fx;
      const float ty = y - fy;
      const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < ww;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hh;
      const int64_t o00 = base + ((int64_t)y0 * ww + x0) * row;
      const int64_t o01 = o00 + row;
      const int64_t o10 = o00 + (int64_t)ww * row;
      const int64_t o11 = o10 + row;
      const float a = ap[lpi];
      const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
      const float w10 = (1.f - tx) * ty, w11 = tx * ty;
      float s_attw = 0.f, s_x = 0.f, s_y = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float g = gp[d];
        const float v00 = (in_y0 && in_x0) ? value[o00 + d] : 0.f;
        const float v01 = (in_y0 && in_x1) ? value[o01 + d] : 0.f;
        const float v10 = (in_y1 && in_x0) ? value[o10 + d] : 0.f;
        const float v11 = (in_y1 && in_x1) ? value[o11 + d] : 0.f;
        s_attw += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
        s_x += g * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
        s_y += g * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
        const float ag = a * g;
        if (in_y0 && in_x0) atomicAdd(dvalue + o00 + d, w00 * ag);
        if (in_y0 && in_x1) atomicAdd(dvalue + o01 + d, w01 * ag);
        if (in_y1 && in_x0) atomicAdd(dvalue + o10 + d, w10 * ag);
        if (in_y1 && in_x1) atomicAdd(dvalue + o11 + d, w11 * ag);
      }
      s_attw = warp_sum(s_attw);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        dap[lpi] = s_attw;
        dlp[lpi * 2] = a * s_x * (float)ww;
        dlp[lpi * 2 + 1] = a * s_y * (float)hh;
      }
    }
  }
}

}  // namespace

// dvalue must be zeroed by the caller (the kernel adds into it).
extern "C" int msda_bwd(const void* value, const void* loc, const void* attw,
                        const void* grad_out, void* dvalue, void* dloc,
                        void* dattw, const void* level_hw, int L, int B, int K,
                        int Q, int H, int D, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || D % 32 != 0) return (int)cudaErrorInvalidValue;
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
  msda_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<const float*>(grad_out),
      static_cast<float*>(dvalue), static_cast<float*>(dloc),
      static_cast<float*>(dattw), B, K, Q, H, D, L, P, lv);
  return (int)cudaGetLastError();
}
