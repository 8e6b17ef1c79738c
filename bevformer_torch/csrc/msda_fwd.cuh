// Multi-scale deformable attention, forward: what the two forward kernels
// share (the level table, the probe modes) and the body of the heads-inner
// kernel (K1), templated on the mode.
//
// The modes split the kernel's cost (the probes of tools/bench_hi_probe.py
// and tools/bench_kernel_probe.py time them). Each is a function of the
// inputs with a plain PyTorch version (kernels/msda.py::msda_probe_plain):
//   kFull     the msda: sum over (level, point) of attw * bilinear sample;
//   kGather   sum over (level, point) of the in-bounds corners' values, with
//             unit weights: the value reads without the weight arithmetic;
//   kWeights  sum over (level, point) of the in-bounds corners' bilinear
//             weight * attw, the same in every channel: the weight
//             arithmetic without the value reads;
//   kNoop     sum over (level, point) of attw, the same in every channel: it
//             reads loc and attw and writes out. (0 * loc is kept: IEEE
//             arithmetic does not fold it, since loc could be inf or NaN.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

enum MsdaMode { kFull = 0, kGather = 1, kWeights = 2, kNoop = 3 };

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// level_hw: host int32 [2L] of (h, w) per level
inline Levels load_levels(const void* level_hw, int L) {
  Levels lv;
  const int* hw = static_cast<const int*>(level_hw);
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return lv;
}

// one in-bounds corner's term: bilinear weight `wgt` times the value at `v`
template <int MODE>
__device__ __forceinline__ float corner_term(float wgt, const float* v) {
  if (MODE == kFull) return wgt * *v;
  if (MODE == kGather) return *v;
  return wgt;  // kWeights
}

// K1: one warp per (b, q, h), lane = channel d
template <int MODE>
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
        const float lx = lp[(l * P + p) * 2];
        const float ly = lp[(l * P + p) * 2 + 1];
        if (MODE == kNoop) {
          acc += ap[l * P + p] + 0.f * (lx + ly);
          continue;
        }
        // __fmul_rn keeps the product out of an FMA, so the pixel position
        // rounds as in the plain version (at x ~ 200 one ulp of an fp32
        // position is 1.5e-5 px)
        const float x = __fmul_rn(lx, (float)ww) - 0.5f;
        const float y = __fmul_rn(ly, (float)hh) - 0.5f;
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
          if (x0 >= 0) v += corner_term<MODE>((1.f - tx) * (1.f - ty), r + (int64_t)x0 * row);
          if (x0 + 1 < ww) v += corner_term<MODE>(tx * (1.f - ty), r + (int64_t)(x0 + 1) * row);
        }
        if (y0 + 1 < hh) {
          const float* r = vb + (int64_t)(y0 + 1) * ww * row;
          if (x0 >= 0) v += corner_term<MODE>((1.f - tx) * ty, r + (int64_t)x0 * row);
          if (x0 + 1 < ww) v += corner_term<MODE>(tx * ty, r + (int64_t)(x0 + 1) * row);
        }
        acc += MODE == kGather ? v : ap[l * P + p] * v;
      }
    }
    out[item * D + d] = acc;
  }
}

template <int MODE>
int launch_msda_fwd(const void* value, const void* loc, const void* attw, void* out,
                    const void* level_hw, int L, int B, int K, int Q, int H, int D,
                    int P, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  const Levels lv = load_levels(level_hw, L);
  const int64_t items = (int64_t)B * Q * H;
  if (items == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_fwd_kernel<MODE><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<float*>(out), B, K, Q, H, D,
      L, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace
