// Multi-scale deformable attention, backward (K3/K4), for Hopper (sm_90a).
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
// What bounds it on this card: bytes, at the least (value, loc, attw and
// grad_out read once, dvalue, dloc and dattw written once). What holds it
// above that: per sample, four corner rows of D floats scattered over the
// value map are read (through L1 and L2, as in the forward) and as many
// rows are added into dvalue, which the L2 performs as atomics: at SCA's
// shape (B 6, Q 10112, H 8, 4 levels x 8 points) up to 62 M corner rows
// each way per call (4 per sample; those off the map are skipped). So the
// corner-request rate and the L2's atomic throughput bound it, not the
// arithmetic.
//
// What the design does about it (K1's mapping, csrc/msda_fwd.cu, run
// backward):
// - One block per (b, head, tile of `tile` consecutive queries), the tiles
//   fastest in the grid, then the heads. Phase 1 writes each sample's four
//   corner pixels (-1 outside) and (tx, ty, attw, level) into shared memory
//   once, not once per lane of every sample, and the tile's grad_out rows
//   of the head. A sample outside the bounds writes its dAttw = dLoc = 0
//   there.
// - Why tiles fastest, where K1 puts the heads fastest: the blocks in
//   flight then read and add into one head's rows of one batch element
//   (value and dvalue, 7.9 MB at SCA, 10.2 MB at TSA), which stay in the
//   50 MB L2; with heads fastest they would span all heads (63 MB at SCA,
//   82 MB at TSA). Measured on an H100 at the path's shapes, tiles fastest
//   took TSA from 0.90 to 0.65 ms and SCA from 2.81 to 2.52 ms a call.
// - 64 registers a thread (four blocks, 32 warps, an SM) to hide the
//   latency of the scattered reads: 0.65 -> 0.50 ms at TSA, 2.52 -> 2.35 at
//   SCA; a tighter cap spills and runs slower.
// - Phase 2: eight lanes cover one 128-byte row of 32 channels, a float4
//   each. Each 8-lane group takes whole samples (SPLIT-way shares of one
//   query's: SPLIT 4 at SCA's 32 samples, 1 at TSA's and the decoder's 4),
//   issues a sample's four corner loads before it uses any, and sums the
//   sample's dAttw, dLoc.x and dLoc.y partials over its 8 lanes with three
//   __shfl_xor steps each. D = 64 and other multiples of 32 loop over
//   32-channel groups before that reduction. A lane reads its channels of
//   grad_out from shared memory, once per sample, never from device memory.
// - dValue: one 16-byte vector atomic add (atomicAdd(float4*, float4),
//   red.global.add.v4.f32 on sm_90) per lane and in-bounds corner whose
//   weight x attw is not 0: 8 atomic instructions per 128-byte corner row,
//   not 32. The adds land in no fixed order, so dValue's last bits are not
//   bitwise deterministic from run to run (nor are those of autograd's
//   scatter on the plain version).
// - The bounds test is the backward's: a sample counts iff -1 <= x < w and
//   -1 <= y < h (NaN fails). At x == -1 the sample is 0 but its slope toward
//   x is not (the plain version and JAX agree); the forward's -1 < x would
//   drop that slope. The pixel position rounds as in the forward and the
//   plain version, __fmul_rn(loc, size) - 0.5f (nvcc would otherwise fuse
//   it into an FMA), so both pick the same corners.
// - The wrapper picks the tile per shape (kernels/msda.py::k1_tile, as for
//   K1). The C entry is the one check of tile, alignment, shared memory
//   and grid.

#include "msda_fwd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 227 * 1024;  // shared memory a block may use on sm_90
constexpr int kMaxTile = 128;           // kernels/msda.py::K1_TILES
constexpr int kBlocksPerSm = 4;         // 64 registers a thread: 32 warps an SM

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// dvalue[p .. p + 3] += w * g, one 16-byte vector atomic (sm_90, global)
__device__ __forceinline__ void red4(float* p, float w, float4 g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
}

template <int SPLIT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
msda_bwd_kernel(const float* __restrict__ value,     // [B, K, H, D]
                const float* __restrict__ loc,       // [B, Q, H, L, P, 2]
                const float* __restrict__ attw,      // [B, Q, H, L, P]
                const float* __restrict__ grad_out,  // [B, Q, H, D]
                float* __restrict__ dvalue,          // [B, K, H, D], zeroed
                float* __restrict__ dloc,            // [B, Q, H, L, P, 2]
                float* __restrict__ dattw,           // [B, Q, H, L, P]
                int K, int Q, int H, int D, int L, int P, int tile, int tiles,
                Levels lv) {
  extern __shared__ int4 payload[];
  const int lp_n = L * P;
  const int items = tile * lp_n;
  const int d4 = D / 4;
  int4* corners = payload;                                       // [tile * L * P]
  float4* params = reinterpret_cast<float4*>(payload + items);   // [tile * L * P]
  float4* grads = params + items;                                // [tile][D / 4]
  const int q0 = (int)(blockIdx.x % tiles) * tile;
  const int rest = (int)(blockIdx.x / tiles);
  const int h = rest % H;
  const int b = rest / H;

  // phase 1: the tile's payload, one sample per thread at a time
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int qi = i / lp_n;
    const int lp = i - qi * lp_n;
    const int q = q0 + qi;
    int4 c = make_int4(-1, -1, -1, -1);
    float4 pr = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < Q) {
      const int64_t it = (((int64_t)b * Q + q) * H + h) * lp_n + lp;
      const int l = lp / P;
      const int hh = lv.h[l];
      const int ww = lv.w[l];
      const float x = __fmul_rn(loc[2 * it], (float)ww) - 0.5f;
      const float y = __fmul_rn(loc[2 * it + 1], (float)hh) - 0.5f;
      // some corner lies inside iff -1 <= x < ww and -1 <= y < hh
      if (x >= -1.f && y >= -1.f && x < (float)ww && y < (float)hh) {
        const float fx = floorf(x);
        const float fy = floorf(y);
        const int x0 = (int)fx;
        const int y0 = (int)fy;
        const int k00 = lv.start[l] + y0 * ww + x0;
        if (y0 >= 0 && x0 >= 0) c.x = k00;
        if (y0 >= 0 && x0 + 1 < ww) c.y = k00 + 1;
        if (y0 + 1 < hh && x0 >= 0) c.z = k00 + ww;
        if (y0 + 1 < hh && x0 + 1 < ww) c.w = k00 + ww + 1;
        pr = make_float4(x - fx, y - fy, attw[it], __int_as_float(l));
      } else {
        dattw[it] = 0.f;
        dloc[2 * it] = 0.f;
        dloc[2 * it + 1] = 0.f;
      }
    }
    corners[i] = c;
    params[i] = pr;
  }
  for (int i = threadIdx.x; i < tile * d4; i += kThreads) {
    const int qi = i / d4;
    const int q = q0 + qi;
    grads[i] = q < Q ? ldg4(grad_out + (((int64_t)b * Q + q) * H + h) * D + 4 * (i - qi * d4))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // phase 2: 8 lanes x 16 bytes per 128-byte row; the warp's four 8-lane
  // groups take SPLIT shares of each of 4 / SPLIT queries. A group's lanes
  // follow one path, so the shuffles name the group's lanes alone
  constexpr int kQueriesPerPass = 4 / SPLIT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;
  const int l8 = lane & 7;
  const unsigned group_mask = 0xffu << (lane & 24);
  const int slot = grp / SPLIT;  // this group's query in the pass
  const int part = grp % SPLIT;  // its share of that query's samples
  const int64_t row = (int64_t)H * D;  // floats between value pixels
  const int64_t lane_base = (int64_t)b * K * row + (int64_t)h * D + 4 * l8;
  const float* vb = value + lane_base;
  float* dvb = dvalue + lane_base;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = warp * kQueriesPerPass; base < tile; base += kWarps * kQueriesPerPass) {
    const int qi = base + slot;
    if (qi >= tile || q0 + qi >= Q) continue;
    const int4* ck = corners + qi * lp_n;
    const float4* cp = params + qi * lp_n;
    const float4* gq = grads + qi * d4 + l8;
    const int64_t it0 = (((int64_t)b * Q + q0 + qi) * H + h) * lp_n;
#pragma unroll 1
    for (int j = part; j < lp_n; j += SPLIT) {
      const int4 c = ck[j];
      if ((c.x & c.y & c.z & c.w) < 0) continue;  // outside: phase 1 wrote its zeros
      const float4 pr = cp[j];
      const float tx = pr.x, ty = pr.y, a = pr.z;
      const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
      const float w10 = (1.f - tx) * ty, w11 = tx * ty;
      const float a00 = w00 * a, a01 = w01 * a, a10 = w10 * a, a11 = w11 * a;
      float s_attw = 0.f, s_x = 0.f, s_y = 0.f;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const float* v = vb + d0;
        const float4 v00 = c.x >= 0 ? ldg4(v + c.x * row) : zero;
        const float4 v01 = c.y >= 0 ? ldg4(v + c.y * row) : zero;
        const float4 v10 = c.z >= 0 ? ldg4(v + c.z * row) : zero;
        const float4 v11 = c.w >= 0 ? ldg4(v + c.w * row) : zero;
        const float4 g = gq[d0 / 4];
        const float4 s = make_float4(
            w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x,
            w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y,
            w00 * v00.z + w01 * v01.z + w10 * v10.z + w11 * v11.z,
            w00 * v00.w + w01 * v01.w + w10 * v10.w + w11 * v11.w);
        const float4 sx = make_float4(
            (1.f - ty) * (v01.x - v00.x) + ty * (v11.x - v10.x),
            (1.f - ty) * (v01.y - v00.y) + ty * (v11.y - v10.y),
            (1.f - ty) * (v01.z - v00.z) + ty * (v11.z - v10.z),
            (1.f - ty) * (v01.w - v00.w) + ty * (v11.w - v10.w));
        const float4 sy = make_float4(
            (1.f - tx) * (v10.x - v00.x) + tx * (v11.x - v01.x),
            (1.f - tx) * (v10.y - v00.y) + tx * (v11.y - v01.y),
            (1.f - tx) * (v10.z - v00.z) + tx * (v11.z - v01.z),
            (1.f - tx) * (v10.w - v00.w) + tx * (v11.w - v01.w));
        s_attw += dot4(g, s);
        s_x += dot4(g, sx);
        s_y += dot4(g, sy);
        float* dv = dvb + d0;
        if (c.x >= 0 && a00 != 0.f) red4(dv + c.x * row, a00, g);
        if (c.y >= 0 && a01 != 0.f) red4(dv + c.y * row, a01, g);
        if (c.z >= 0 && a10 != 0.f) red4(dv + c.z * row, a10, g);
        if (c.w >= 0 && a11 != 0.f) red4(dv + c.w * row, a11, g);
      }
#pragma unroll
      for (int m = 1; m < 8; m <<= 1) {
        s_attw += __shfl_xor_sync(group_mask, s_attw, m);
        s_x += __shfl_xor_sync(group_mask, s_x, m);
        s_y += __shfl_xor_sync(group_mask, s_y, m);
      }
      if (l8 == 0) {
        const int l = __float_as_int(pr.w);
        const int64_t it = it0 + j;
        dattw[it] = s_attw;
        dloc[2 * it] = a * s_x * (float)lv.w[l];
        dloc[2 * it + 1] = a * s_y * (float)lv.h[l];
      }
    }
  }
}

template <int SPLIT>
int launch_split(const float* value, const float* loc, const float* attw, const float* grad_out,
                 float* dvalue, float* dloc, float* dattw, const Levels& lv, int K, int Q,
                 int H, int D, int L, int P, int tile, int tiles, unsigned blocks, size_t smem,
                 cudaStream_t stream) {
  auto kernel = msda_bwd_kernel<SPLIT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(value, loc, attw, grad_out, dvalue, dloc, dattw,
                                             K, Q, H, D, L, P, tile, tiles, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// dvalue must be zeroed by the caller (the kernel adds into it). tile:
// queries per block (the wrapper's kernels/msda.py::k1_tile). The one check
// of the arguments: a tile of 1, 2, 4, ..., kMaxTile queries, D a multiple
// of 32, value, grad_out and dvalue on 16-byte boundaries (the float4 loads
// and vector atomics), a payload that fits shared memory and a grid that
// fits one dimension; anything else returns cudaErrorInvalidValue, which
// the wrapper raises.
extern "C" int msda_bwd(const void* value, const void* loc, const void* attw,
                        const void* grad_out, void* dvalue, void* dloc,
                        void* dattw, const void* level_hw, int L, int B, int K,
                        int Q, int H, int D, int P, int tile, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 32 || D % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (tile < 1 || tile > kMaxTile || (tile & (tile - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)value | (uintptr_t)grad_out | (uintptr_t)dvalue) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int lp_n = L * P;
  const size_t smem = (size_t)tile * lp_n * (sizeof(int4) + sizeof(float4)) +
                      (size_t)tile * D * sizeof(float);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const Levels lv = load_levels(level_hw, L);
  if ((int64_t)B * Q * H == 0) return (int)cudaSuccess;
  const int tiles = (Q + tile - 1) / tile;
  const int64_t blocks = (int64_t)B * H * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // SPLIT groups per query, as many as give each at least 4 samples
  const int split = lp_n >= 16 ? 4 : lp_n >= 8 ? 2 : 1;
  const float* v = static_cast<const float*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  const float* g = static_cast<const float*>(grad_out);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattw);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned n = (unsigned)blocks;
  switch (split) {
    case 1: return launch_split<1>(v, lo, a, g, dv, dl, da, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
    case 2: return launch_split<2>(v, lo, a, g, dv, dl, da, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
    default: return launch_split<4>(v, lo, a, g, dv, dl, da, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
  }
}
