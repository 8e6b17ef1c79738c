// Multi-scale deformable attention, forward, heads outer (K7), for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel bevformer_tpu/kernels/msda_pallas.py::
// _kernel (launched from _forward, entry ms_deform_attn_pallas): the
// heads-outer msda forward, one grid row per batch*head, whose items
// (query, point) arrive with a per-item bilinear payload (_payload_level)
// and whose per-query point sum happens inside the kernel. The function is
// K1's (bevformer_tpu/kernels/msda.py::ms_deform_attn_jnp, grid_sample
// align_corners=False, zeros outside), with K1's layouts: value [B, K, H, D],
// loc [B, Q, H, L, P, 2], attw [B, Q, H, L, P] -> out [B, Q, H*D].
//
// What bounds it on this card: the scattered corner reads, as for K1: 4
// corners x L x P rows of D floats per (b, q, h), a few flops per byte, so
// memory latency and bandwidth bound it; the least time is the bytes of
// value, loc, attw and out at the card's memory rate.
//
// What the design does about it: one block per (b*h, tile of QB consecutive
// queries), heads outer. Phase 1 builds the tile's payload in shared memory:
// for each (query, level, point) the four corner pixels (-1 outside) and the
// four weights bilinear * attw, computed once per item instead of once per
// lane (K1 recomputes them in every lane). Phase 2 maps lane = channel: each
// warp sums one query's items from shared memory (broadcast reads) with one
// coalesced 128-byte read per corner and one write per query, in ACC
// independent accumulators. The TPU kernel drops an item whose rows miss its
// window; this one reads every corner wherever it lies, so no mass is
// dropped and there is nothing to audit.
//
// Template parameters: the mode (kFull, or a cost-split mode of
// csrc/msda_fwd.cuh, the counterpart of tools/bench_kernel_probe.py), QB and
// ACC (the tile and accumulator sweep of tools/bench_kernel_probe3.py). The
// C entry dispatches to a fixed set of instantiations: kFull at every
// (QB, ACC) of the sweep, the other modes at the default tile.

#include "msda_fwd.cuh"

namespace {

constexpr int kHoThreads = 256;
constexpr int kHoTile = 16;  // kernels/msda.py::HO_TILE
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use on sm_90

template <int MODE>
__device__ __forceinline__ float item_term(int4 c, float4 w, const float* v, int64_t row) {
  if (MODE == kNoop) return w.x;
  if (MODE == kWeights) return (w.x + w.y) + (w.z + w.w);
  float s = 0.f;
  if (c.x >= 0) s += corner_term<MODE>(w.x, v + c.x * row);
  if (c.y >= 0) s += corner_term<MODE>(w.y, v + c.y * row);
  if (c.z >= 0) s += corner_term<MODE>(w.z, v + c.z * row);
  if (c.w >= 0) s += corner_term<MODE>(w.w, v + c.w * row);
  return s;
}

template <int MODE, int QB, int ACC>
__global__ void __launch_bounds__(kHoThreads)
msda_fwd_ho_kernel(const float* __restrict__ value,  // [B, K, H, D]
                   const float* __restrict__ loc,    // [B, Q, H, L, P, 2]
                   const float* __restrict__ attw,   // [B, Q, H, L, P]
                   float* __restrict__ out,          // [B, Q, H, D]
                   int K, int Q, int H, int D, int L, int P, Levels lv) {
  extern __shared__ int4 smem[];
  const int lp_n = L * P;
  const int items = QB * lp_n;
  int4* corners = smem;                                     // [QB * L * P]
  float4* weights = reinterpret_cast<float4*>(smem + items);  // [QB * L * P]
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * QB;

  // phase 1: the tile's payload, one item per thread at a time
  for (int i = threadIdx.x; i < items; i += kHoThreads) {
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
        // as K1: __fmul_rn keeps loc * size out of an FMA
        const float x = __fmul_rn(lx, (float)ww) - 0.5f;
        const float y = __fmul_rn(ly, (float)hh) - 0.5f;
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
  __syncthreads();

  // phase 2: lane = channel, one query per warp at a time
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)H * D;  // stride between value pixels
  const float* vb = value + (int64_t)b * K * row + (int64_t)h * D;
  for (int qi = warp; qi < QB && q0 + qi < Q; qi += kHoThreads / 32) {
    const int4* ck = corners + qi * lp_n;
    const float4* cw = weights + qi * lp_n;
    float* op = out + (((int64_t)b * Q + q0 + qi) * H + h) * D;
    for (int d = lane; d < D; d += 32) {
      float acc[ACC];
#pragma unroll
      for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
      for (int j = 0; j < lp_n; j += ACC) {
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          if (j + a < lp_n) acc[a] += item_term<MODE>(ck[j + a], cw[j + a], vb + d, row);
        }
      }
      float s = acc[0];
#pragma unroll
      for (int a = 1; a < ACC; ++a) s += acc[a];
      op[d] = s;
    }
  }
}

template <int MODE, int QB, int ACC>
int launch_ho(const float* value, const float* loc, const float* attw, float* out,
              const Levels& lv, int L, int B, int K, int Q, int H, int D, int P,
              cudaStream_t stream) {
  const size_t smem = (size_t)QB * L * P * (sizeof(int4) + sizeof(float4));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = msda_fwd_ho_kernel<MODE, QB, ACC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((Q + QB - 1) / QB), (unsigned)(B * H));
  kernel<<<grid, kHoThreads, smem, stream>>>(value, loc, attw, out, K, Q, H, D, L, P, lv);
  return (int)cudaGetLastError();
}

template <int QB, int ACC>
int launch_full(const float* v, const float* lo, const float* a, float* o, const Levels& lv,
                int L, int B, int K, int Q, int H, int D, int P, cudaStream_t s) {
  return launch_ho<kFull, QB, ACC>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
}

}  // namespace

// mode: MsdaMode; tile: queries per block (8, 16, 32, 64 for kFull,
// kHoTile otherwise); acc: independent accumulators per lane (1, 2 for
// kFull, 1 otherwise). This is the one check of the arguments: any other
// (mode, tile, acc), a payload larger than shared memory or B*H above grid
// y's 65535 returns cudaErrorInvalidValue, which the wrapper raises.
extern "C" int msda_fwd_ho(const void* value, const void* loc, const void* attw, void* out,
                           const void* level_hw, int L, int B, int K, int Q, int H, int D,
                           int P, int mode, int tile, int acc, void* stream) {
  if (L < 1 || L > kMaxLevels || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Levels lv = load_levels(level_hw, L);
  if ((int64_t)B * Q * H == 0) return (int)cudaSuccess;
  const float* v = static_cast<const float*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kFull) {
    const int key = tile * 10 + acc;
    switch (key) {
      case 81: return launch_full<8, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 82: return launch_full<8, 2>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 161: return launch_full<16, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 162: return launch_full<16, 2>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 321: return launch_full<32, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 322: return launch_full<32, 2>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 641: return launch_full<64, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      case 642: return launch_full<64, 2>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (tile != kHoTile || acc != 1) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kGather: return launch_ho<kGather, kHoTile, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
    case kWeights: return launch_ho<kWeights, kHoTile, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
    case kNoop: return launch_ho<kNoop, kHoTile, 1>(v, lo, a, o, lv, L, B, K, Q, H, D, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
