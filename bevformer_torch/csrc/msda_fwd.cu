// Multi-scale deformable attention, forward (K1), for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel bevformer_tpu/kernels/msda_hi.py::_kernel_hi
// (launched from _forward_hi and _forward_hi_lw), which computes the op as
// windowed multi-hot matmuls because the TPU has no fast gather. The
// function is bevformer_tpu/kernels/msda.py::ms_deform_attn_jnp: for each
// (b, q, h) sum over (level, point) of attw * bilinear(value_l, loc), with
// pixel = loc * size - 0.5 (grid_sample, align_corners=False) and zeros
// outside the map, accumulated in fp32. Layouts: value [B, K, H, D], loc
// [B, Q, H, L, P, 2], attw [B, Q, H, L, P] -> out [B, Q, H*D].
//
// What bounds it on this card: gathers. Each (b, q, h) reads 4 corners x
// L x P rows of D floats from a value map that is scattered in memory, 2
// flops per byte read, so the latency and rate of those reads bound it (the
// least time is the bytes of value, loc, attw and out at the memory rate;
// the corner requests themselves are many times that, through L1 and L2).
//
// What the design does about it (from K7's measured design, then further):
// - One block per (b, head, tile of `tile` consecutive queries), heads
//   fastest in the grid so that the blocks in flight share value rows.
//   Phase 1 writes each sample's four corner pixels (-1 outside) and its
//   four bilinear weights x attw into shared memory, once per sample, not
//   once per lane of every sample as the first K1 did (its `weights` share
//   of the time was 46% at SCA).
// - Phase 2 reads corners with 16-byte loads: eight lanes cover one
//   128-byte row of 32 channels (a float4 each), so one warp load moves
//   four rows. The four 8-lane groups of a warp take SPLIT-way shares of
//   one query's samples (4 / SPLIT queries per warp pass; SPLIT 4 at SCA's
//   32 samples, 1 at TSA's and the decoder's 4); each lane issues the four
//   corner loads of a sample before it uses any, and the shares are summed
//   by __shfl_xor. D = 64 and other multiples of 32 loop over 32-channel
//   groups.
// - Sums follow the plain version's order: per level, each corner over the
//   points, then the corners in turn. With one group per query (TSA, the
//   decoder) most outputs then agree with the plain version bitwise
//   (chip_smoke.py prints the share), so the kernel path's rounding moves
//   the model's outputs and gradients less far from the plain path's.
// - The wrapper picks the tile per shape (kernels/msda.py::k1_tile): TSA
//   and the decoder have 4 samples per query, SCA 32, and one fixed tile
//   would leave TSA's phase 1 mostly idle. The C entry is the one check of
//   tile, shared memory and grid.
// - The pixel position rounds as in the plain version and in the backward
//   (csrc/msda_bwd.cu recomputes the same corners): __fmul_rn(loc, size) -
//   0.5f, which nvcc would otherwise fuse into an FMA.
//
// `msda_fwd` runs the msda (kFull) and `msda_fwd_probe` the cost-split
// modes of csrc/msda_fwd.cuh on the same body (the counterpart of
// tools/bench_hi_probe.py's kernel variants).

#include "msda_fwd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 227 * 1024;  // shared memory a block may use on sm_90
constexpr int kMaxTile = 128;           // kernels/msda.py::K1_TILES

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

// one sample's terms for this lane's 4 channels, into one accumulator per
// corner: `v` points at the channels in the sample's pixel 0 of the batch,
// `row` floats between pixels. The four corner loads go out before any is
// used
template <int MODE>
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
  const float4 v0 = c.x >= 0 ? ldg4(v + c.x * row) : zero;
  const float4 v1 = c.y >= 0 ? ldg4(v + c.y * row) : zero;
  const float4 v2 = c.z >= 0 ? ldg4(v + c.z * row) : zero;
  const float4 v3 = c.w >= 0 ? ldg4(v + c.w * row) : zero;
  const bool unit = MODE == kGather;
  fma4(s[0], unit ? 1.f : w.x, v0);
  fma4(s[1], unit ? 1.f : w.y, v1);
  fma4(s[2], unit ? 1.f : w.z, v2);
  fma4(s[3], unit ? 1.f : w.w, v3);
}

template <int MODE, int SPLIT>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const float* __restrict__ value,  // [B, K, H, D]
                const float* __restrict__ loc,    // [B, Q, H, L, P, 2]
                const float* __restrict__ attw,   // [B, Q, H, L, P]
                float* __restrict__ out,          // [B, Q, H, D]
                int K, int Q, int H, int D, int L, int P, int tile, int tiles,
                Levels lv) {
  extern __shared__ int4 payload[];
  const int lp_n = L * P;
  const int items = tile * lp_n;
  int4* corners = payload;                                      // [tile * L * P]
  float4* weights = reinterpret_cast<float4*>(payload + items);  // [tile * L * P]
  const int h = (int)(blockIdx.x % H);
  const int rest = (int)(blockIdx.x / H);
  const int q0 = (rest % tiles) * tile;
  const int b = rest / tiles;

  // phase 1: the tile's payload, one sample per thread at a time
  for (int i = threadIdx.x; i < items; i += kThreads) {
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
  __syncthreads();

  // phase 2: 8 lanes x 16 bytes per 128-byte row; the warp's four 8-lane
  // groups take SPLIT shares of each of 4 / SPLIT queries
  constexpr int kQueriesPerPass = 4 / SPLIT;
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
        // the points, then the corners in turn (with SPLIT 1, as at TSA,
        // most outputs agree with it bitwise)
        for (int l = 0; l < L; ++l) {
          float4 s[4] = {zero, zero, zero, zero};
          // this group's share of the level: every SPLIT-th sample, from
          // the first whose index is `part` modulo SPLIT
          const int first = l * P + (part - l * P % SPLIT + SPLIT) % SPLIT;
#pragma unroll 2
          for (int j = first; j < (l + 1) * P; j += SPLIT)
            add_sample<MODE>(s, ck[j], cw[j], vb + d0, row);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc.x += s[k].x;
            acc.y += s[k].y;
            acc.z += s[k].z;
            acc.w += s[k].w;
          }
        }
      }
      if (SPLIT >= 2) acc = shfl_xor4(acc, 8);
      if (SPLIT == 4) acc = shfl_xor4(acc, 16);
      if (active && part == 0) *reinterpret_cast<float4*>(op + d0) = acc;
    }
  }
}

template <int MODE, int SPLIT>
int launch_split(const float* value, const float* loc, const float* attw, float* out,
                 const Levels& lv, int K, int Q, int H, int D, int L, int P, int tile,
                 int tiles, unsigned blocks, size_t smem, cudaStream_t stream) {
  auto kernel = msda_fwd_kernel<MODE, SPLIT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(value, loc, attw, out, K, Q, H, D, L, P, tile,
                                             tiles, lv);
  return (int)cudaGetLastError();
}

// The one check of the arguments: a tile of 1, 2, 4, ..., kMaxTile queries,
// a payload that fits shared memory, a grid that fits one dimension, D a
// multiple of 32, and value and out on 16-byte boundaries (the float4
// loads and stores); anything else returns cudaErrorInvalidValue, which the
// wrapper raises.
template <int MODE>
int launch_msda_fwd(const void* value, const void* loc, const void* attw, void* out,
                    const void* level_hw, int L, int B, int K, int Q, int H, int D,
                    int P, int tile, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D % 32 != 0) return (int)cudaErrorInvalidValue;
  if (tile < 1 || tile > kMaxTile || (tile & (tile - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)value | (uintptr_t)out) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int lp_n = L * P;
  const size_t smem = (size_t)tile * lp_n * (sizeof(int4) + sizeof(float4));
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const Levels lv = load_levels(level_hw, L);
  if ((int64_t)B * Q * H == 0) return (int)cudaSuccess;
  const int tiles = (Q + tile - 1) / tile;
  const int64_t blocks = (int64_t)B * H * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // SPLIT groups per query, as many as give each at least 4 samples (one
  // group per query keeps the plain version's order of sums)
  const int split = lp_n >= 16 ? 4 : lp_n >= 8 ? 2 : 1;
  const float* v = static_cast<const float*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned n = (unsigned)blocks;
  switch (split) {
    case 1: return launch_split<MODE, 1>(v, lo, a, o, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
    case 2: return launch_split<MODE, 2>(v, lo, a, o, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
    default: return launch_split<MODE, 4>(v, lo, a, o, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
  }
}

}  // namespace

// tile: queries per block (the wrapper's kernels/msda.py::k1_tile)
extern "C" int msda_fwd(const void* value, const void* loc, const void* attw,
                        void* out, const void* level_hw, int L, int B, int K,
                        int Q, int H, int D, int P, int tile, void* stream) {
  return launch_msda_fwd<kFull>(value, loc, attw, out, level_hw, L, B, K, Q, H, D, P, tile,
                                stream);
}

extern "C" int msda_fwd_probe(const void* value, const void* loc, const void* attw,
                              void* out, const void* level_hw, int L, int B, int K,
                              int Q, int H, int D, int P, int mode, int tile,
                              void* stream) {
  switch (mode) {
    case kGather:
      return launch_msda_fwd<kGather>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                      P, tile, stream);
    case kWeights:
      return launch_msda_fwd<kWeights>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                       P, tile, stream);
    case kNoop:
      return launch_msda_fwd<kNoop>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                    P, tile, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
