// Multi-scale deformable attention: what the two forward kernels, K1
// (csrc/msda_fwd.cu) and K7 (csrc/msda_fwd_ho.cu), share: the level table
// (which the backward, csrc/msda_bwd.cu, reads too) and the probe modes.
//
// The modes split a kernel's cost (the probes of tools/bench_hi_probe.py
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

}  // namespace
