// Multi-scale deformable attention: what the two forward kernels, K1
// (csrc/msda_fwd.cu) and K7 (csrc/msda_fwd_ho.cu), share: the level table
// (which the backward, csrc/msda_bwd.cu, reads too), the probe modes, and
// the two phases of a block (they differ in how the grid maps blocks to
// (batch, head, query tile), in the tile, and in K7's accumulators):
// - build_payload: each sample's four corner pixels (-1 outside) and four
//   bilinear weights x attw, once per sample, into shared memory;
// - sum_payload: 8 lanes x 16 bytes per 128-byte corner row; the warp's
//   four 8-lane groups take SPLIT shares of each of 4 / SPLIT queries, with
//   ACC independent sets of corner accumulators each, summed in the plain
//   version's order (per level, each corner over the points, then the
//   corners in turn) and across the groups by __shfl_xor.
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

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void add4(float4& acc, float s) {
  acc.x += s;
  acc.y += s;
  acc.z += s;
  acc.w += s;
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int m) {
  v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
  v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
  v.z += __shfl_xor_sync(0xffffffffu, v.z, m);
  v.w += __shfl_xor_sync(0xffffffffu, v.w, m);
  return v;
}

// a 16-byte load of the value at p where `live`, else zeros. The asm is
// volatile, so the four corner loads of a sample leave in order, all before
// their first use
__device__ __forceinline__ float4 ldg4_if(bool live, const float* p) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %4, 0;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5];\n\t}"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "r"((int)live), "l"(p));
  return v;
}

// one sample's terms for this lane's 4 channels, into one accumulator per
// corner: `v` points at the channels in the sample's pixel 0 of the batch,
// `row` floats between pixels. The four corner loads go out before any is
// used. At SPLIT 1 and 2 ptxas gave the four loads of each sample one
// register set and waited on each in turn unless ldg4_if pins them (K1 in
// `tools/bench_msda_kernel --tsa` on an H100: 0.232 ms a call, 0.190
// pinned); at SPLIT 4 it rotates three sets by itself, and pinning cost 4%
// at SCA (1.314 ms, 1.362 pinned)
template <int MODE, int SPLIT>
__device__ __forceinline__ void add_sample(float4 (&s)[4], int4 c, float4 w, const float* v,
                                           int64_t row) {
  if (MODE == kNoop) {
    add4(s[0], w.x);
    return;
  }
  if (MODE == kWeights) {
    add4(s[0], w.x);
    add4(s[1], w.y);
    add4(s[2], w.z);
    add4(s[3], w.w);
    return;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool pin = SPLIT <= 2;
  const float4 v0 = pin ? ldg4_if(c.x >= 0, v + c.x * row) : c.x >= 0 ? ldg4(v + c.x * row) : zero;
  const float4 v1 = pin ? ldg4_if(c.y >= 0, v + c.y * row) : c.y >= 0 ? ldg4(v + c.y * row) : zero;
  const float4 v2 = pin ? ldg4_if(c.z >= 0, v + c.z * row) : c.z >= 0 ? ldg4(v + c.z * row) : zero;
  const float4 v3 = pin ? ldg4_if(c.w >= 0, v + c.w * row) : c.w >= 0 ? ldg4(v + c.w * row) : zero;
  const bool unit = MODE == kGather;
  fma4(s[0], unit ? 1.f : w.x, v0);
  fma4(s[1], unit ? 1.f : w.y, v1);
  fma4(s[2], unit ? 1.f : w.z, v2);
  fma4(s[3], unit ? 1.f : w.w, v3);
}

// SPLIT groups per query of `samples` = L * P samples: as many as give each
// at least 4 samples (one group per query keeps the plain version's order
// of sums)
inline int split_for(int samples) { return samples >= 16 ? 4 : samples >= 8 ? 2 : 1; }

// phase 1: the payload of the `tile` queries from q0 of (b, h), one sample
// per thread at a time
template <int MODE, int THREADS>
__device__ __forceinline__ void build_payload(int4* corners, float4* weights,
                                              const float* __restrict__ loc,
                                              const float* __restrict__ attw, int b, int h,
                                              int q0, int tile, int Q, int H, int L, int P,
                                              const Levels& lv) {
  const int lp_n = L * P;
  const int items = tile * lp_n;
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int qi = i / lp_n;
    const int lp = i - qi * lp_n;
    const int q = q0 + qi;
    int4 c = make_int4(-1, -1, -1, -1);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < Q) {
      const int64_t it = (((int64_t)b * Q + q) * H + h) * lp_n + lp;
      const float lx = loc[2 * it];
      const float ly = loc[2 * it + 1];
      const float a = attw[it];
      if (MODE == kNoop) {
        w.x = a + 0.f * (lx + ly);
      } else {
        const int l = lp / P;
        const int hh = lv.h[l];
        const int ww = lv.w[l];
        // __fmul_rn keeps loc * size out of an FMA, so the pixel position
        // rounds as in the plain version (at x ~ 200 one ulp of an fp32
        // position is 1.5e-5 px)
        const float x = __fmul_rn(lx, (float)ww) - 0.5f;
        const float y = __fmul_rn(ly, (float)hh) - 0.5f;
        // all four corners lie outside unless -1 < x < ww and -1 < y < hh
        // (NaN fails too)
        if (x > -1.f && y > -1.f && x < (float)ww && y < (float)hh) {
          const float fx = floorf(x);
          const float fy = floorf(y);
          const int x0 = (int)fx;
          const int y0 = (int)fy;
          const float tx = x - fx;
          const float ty = y - fy;
          const int k00 = lv.start[l] + y0 * ww + x0;
          if (y0 >= 0 && x0 >= 0) { c.x = k00; w.x = (1.f - tx) * (1.f - ty) * a; }
          if (y0 >= 0 && x0 + 1 < ww) { c.y = k00 + 1; w.y = tx * (1.f - ty) * a; }
          if (y0 + 1 < hh && x0 >= 0) { c.z = k00 + ww; w.z = (1.f - tx) * ty * a; }
          if (y0 + 1 < hh && x0 + 1 < ww) { c.w = k00 + ww + 1; w.w = tx * ty * a; }
        }
      }
    }
    corners[i] = c;
    weights[i] = w;
  }
}

// phase 2: the outputs of the payload's queries. 8 lanes x 16 bytes per
// 128-byte row; the warp's four 8-lane groups take SPLIT shares of each of
// 4 / SPLIT queries, each share into ACC sets of four corner accumulators
// (sample j of the share into set (j / SPLIT) % ACC, ACC samples in flight)
template <int MODE, int SPLIT, int ACC, int THREADS>
__device__ __forceinline__ void sum_payload(const int4* corners, const float4* weights,
                                            const float* __restrict__ value,
                                            float* __restrict__ out, int b, int h, int q0,
                                            int tile, int K, int Q, int H, int D, int L,
                                            int P) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kQueriesPerPass = 4 / SPLIT;
  const int lp_n = L * P;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;
  const int slot = grp / SPLIT;  // this group's query in the pass
  const int part = grp % SPLIT;  // its share of that query's samples
  const int64_t row = (int64_t)H * D;  // floats between value pixels
  const float* vb = value + (int64_t)b * K * row + (int64_t)h * D + 4 * (lane & 7);
  // the loop bounds are the same in every lane: the shuffles need them all
  for (int base = warp * kQueriesPerPass; base < tile; base += kWarps * kQueriesPerPass) {
    const int qi = base + slot;
    const bool active = qi < tile && q0 + qi < Q;
    const int4* ck = corners + qi * lp_n;
    const float4* cw = weights + qi * lp_n;
    float* op = out + (((int64_t)b * Q + q0 + qi) * H + h) * D + 4 * (lane & 7);
    for (int d0 = 0; d0 < D; d0 += 32) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 acc = zero;
      if (active) {
        // the plain version's order: per level, each corner summed over
        // the points, then the corners in turn (with SPLIT 1 and ACC 1, as
        // K1 at TSA, most outputs agree with it bitwise)
        for (int l = 0; l < L; ++l) {
          float4 s[ACC][4];
#pragma unroll
          for (int a = 0; a < ACC; ++a) s[a][0] = s[a][1] = s[a][2] = s[a][3] = zero;
          // this group's share of the level: every SPLIT-th sample, from
          // the first whose index is `part` modulo SPLIT
          const int first = l * P + (part - l * P % SPLIT + SPLIT) % SPLIT;
          const int end = (l + 1) * P;
#pragma unroll 2
          for (int j = first; j < end; j += SPLIT * ACC) {
#pragma unroll
            for (int a = 0; a < ACC; ++a) {
              const int jj = j + a * SPLIT;
              if (a == 0 || jj < end) add_sample<MODE, SPLIT>(s[a], ck[jj], cw[jj], vb + d0, row);
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
#pragma unroll
            for (int a = 0; a < ACC; ++a) {
              acc.x += s[a][k].x;
              acc.y += s[a][k].y;
              acc.z += s[a][k].z;
              acc.w += s[a][k].w;
            }
          }
        }
      }
      if (SPLIT >= 2) acc = shfl_xor4(acc, 8);
      if (SPLIT == 4) acc = shfl_xor4(acc, 16);
      if (active && part == 0) *reinterpret_cast<float4*>(op + d0) = acc;
    }
  }
}

}  // namespace
