// DCNv2 sampling backward (col2im and col2im_coord), for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels bevformer_tpu/kernels/msda_pallas.py::
// _bwd_aux_kernel and _bwd_dval_kernel (launched from _backward), which
// bevformer_tpu/kernels/dcn_pallas.py::_bwd calls with the DCN sampling
// recast as single-level msda (items = (pixel, tap), heads = C/32, p = 1)
// so that the TPU's windowed matmuls can scatter. Here it is written as the
// DCN backward itself, with the semantics of mmcv's
// modulated_deformable_col2im (dx) and modulated_deformable_col2im_coord
// (d offsets, d mask): given dcols = d(loss)/d(cols) of
// csrc/dcn_im2col.cu's column, for output pixel m and tap t sampling at
// (py, px) with corner weights w.. over the in-bounds corners v..,
//   dx[corner, c]  += dcols[m, t*C + c] * mask * w_corner
//   dmask[m, t]     = sum_c dcols * bilinear(x)
//   doff_y[m, t]    = mask * sum_c dcols * ((1-tx)(v10-v00) + tx(v11-v01))
//   doff_x[m, t]    = mask * sum_c dcols * ((1-ty)(v01-v00) + ty(v11-v10))
// There is no clip, so no clip mask on doff_y either.
//
// What bounds it on this card: bytes and atomics. Per (pixel, tap) it
// reads C floats of dcols (once: 320.7 MB at R101 stage 3 of
// bevformer_base) and 4 x C of x (35.6 MB there, in L2), and adds 4 x C
// floats into dx; neighbouring pixels and taps hit the same corners, so the
// L2's atomic throughput is the limit.
//
// What the design does about it (K5's structure, csrc/dcn_im2col.cu):
// - One block per BM = 8 output pixels. Phase 1 builds, once per (pixel,
//   tap), the four corners' float4 offsets into x and dx (-1 outside),
//   their bilinear weights, the fractional parts ty and tx, and the mask,
//   into shared memory: the index arithmetic and the loads of off_y, off_x
//   and mask happen once per (pixel, tap), with no 64-bit division. The
//   bounds test is the backward's: the sample counts iff -1 <= py < H and
//   -1 <= px < W, so at py == -1 the row-0 corners carry weight 0 and their
//   slope.
// - Phase 2: one warp per (pixel, tap) row of C channels; a lane takes 4
//   channels at a time with 16-byte loads of the four corners of x and a
//   streaming 16-byte load of dcols (__ldcs, evict first: it is read once),
//   and adds into dx with 16-byte vector atomics (atomicAdd(float4*),
//   REDG.E.ADD.F32x4): 8 atomic instructions per 128-byte corner row
//   instead of 32 scalar ones.
// - The three channel sums go through the warp's shuffles in a fixed order
//   and lane 0 writes them: d offsets and dmask are deterministic. dx is
//   scattered with atomics, so its last bits depend on the order the warps
//   run in: it is not bitwise deterministic from run to run (nor is
//   autograd's scatter on the plain version).
// - The C entry takes C a multiple of 4 and x, dcols and dx on 16-byte
//   boundaries (the float4 loads and atomics); the model's caller, the DCN
//   backward, has C a multiple of 32.
//
// bf16 (`dcn_col2im_gw`, the counterpart of dcn_pallas._conv_bwd's
// dsampled einsum and _bwd at compute_dtype=bfloat16: the sampling half of
// the backward of the DCN on a bf16 x). It takes the bf16 output gradient
// g [B*OH*OW, Cout] and the weight, not dcols: dcols = g W^T, both
// operands exactly bf16 (g is the gradient of the bf16 output, the weight
// is rounded once to bf16 as the forward rounds it), so their products are
// exact in fp32 and the tensor cores compute the same dcols, summed in
// another order, at 989 TFLOP/s.
//
// What bounds it on this card: dx's atomic adds, as in fp32 K6. A base
// stage-3 call adds 1196 MB into the fp32 dx workspace (4 corners x C
// floats per (pixel, tap)); at fp32 K6's 2.45 TB/s that is ~0.49 ms, while
// the product is 41 GFLOP (0.042 ms at 989 TFLOP/s) and the bytes every
// input and output need once ~0.02 ms. Before this kernel the bf16 backward
// built dcols as an fp32 SIMT product (0.888 ms a base call, measured as
// below) and wrote and read its 320.7 MB through device memory.
//
// What the design does about it:
// - dcols never leaves the SM. One persistent block of 384 threads an SM
//   walks units, a unit being one 64-pixel tile at one tap with all C
//   channels of it, in parts of 256 channels (one part at C 256, two at
//   512): each (pixel, tap) row's three channel sums stay in one warp and
//   are added in a fixed order, so d offsets and dmask are deterministic,
//   as in fp32 K6. Block i takes units i, i + G, i + 2G, ...: the blocks
//   sweep the image together, so the dx lines their adds hit at any time
//   are few and stay in the L2. (Contiguous ranges of units a block, as
//   bf16 K2 walks its pixels, spread the adds over all of dx: 0.687 ms a
//   base stage-3 call against 0.502, tools/bench_dcn_bwd_bf16.py
//   --variant ranges.)
// - Warpgroup 0 makes each part's dcols [64 px, 256 ch] with m64n256k16
//   wgmma, one fp32 accumulator over K = Cout: A the g tile (K-major as
//   it lies in memory; 16-byte cp.async into the 128-byte swizzle, rows
//   past M zero-filled), B the weight's rows of this tap and part (K-major
//   as they lie; a prep kernel rounds the fp32 weight to bf16 once a call
//   and lays each 256-row block out in core matrices, so one
//   cp.async.bulk brings a 256 x 64 tile). The two operands come through
//   a ring of two stages, the next K tile's copies in flight while this
//   one multiplies. The warpgroup then stores its accumulators into one of
//   two fp32 staging tiles in shared memory (rows 264 floats apart:
//   conflict-free 8-byte stores) and hands it over by an mbarrier.
// - Warps 4-11 scatter from the staging tile: K6's phase 2 fed from shared
//   memory, not device memory. Each owns 8 pixels of every unit and builds
//   their corner tables for the unit's tap (fp32 K6's arithmetic and
//   bounds test, -1 <= p < size, unchanged) from offsets fetched a unit
//   ahead; a warp takes one (pixel, tap) row at a time with the next two
//   rows' corner loads in flight, a lane 4 channels of each half of the
//   part: 8-byte bf16 corner loads widened exactly, dx's adds by 16-byte
//   vector atomics into the fp32 workspace (which the wrapper zeroes and
//   rounds to bf16 once). Each row's three sums go through the warp's
//   shuffles in fp32 K6's order, the 8 rows' shuffles interleaved at the
//   part's end, and are kept per row in shared memory across the parts.
// - 168 registers a thread (the m64n256 accumulators want 128: at 512
//   threads a thread has 128 in all, and 12 scatter warps with the
//   product in two n128 halves were slower), 217 KB of shared memory.
// Measured (tools/bench_dcn_bwd_bf16.py, NVIDIA H100 80GB HBM3, 700.00 W,
// offsets N(0, 3) px): 0.502 ms a base stage-3 call, 0.306 a stage-4 one;
// the route before it, the fp32 product and dcn_col2im_bf16 on its
// column gradient, 1.373 and 1.124. The scatter alone takes 0.471 and
// 0.241 (its dx adds at 2.5 TB/s, fp32 K6's rate), the product and its
// hand-over alone 0.239 and 0.232: stage 3 is bound by the atomics, stage
// 4 by both sides about equally.
// x on 8-byte boundaries; g, dx and the prepared weight on 16; C a
// multiple of 4, Cout of 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_vec4.cuh"
#include "sm90_wgmma.cuh"

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;            // output pixels per block
constexpr int ROWS = BM * TAPS;  // (pixel, tap) rows per block

struct Tables {
  int4 idx[ROWS];   // element offset of each corner's channel 0 in x and dx, -1 outside
  float4 w[ROWS];   // bilinear weight of each corner
  float4 tym[ROWS];  // ty, tx, mask, and 1 where the sample counts (else 0)
};

__device__ __forceinline__ float4 corner(const float* __restrict__ x, int idx, int c) {
  return idx >= 0 ? ldg4(x + idx + c) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void red4(float* p, float w, float4 g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sample of output pixel m at tap t: the element offset of each
// corner's channel 0 in x and dx (-1 outside), their bilinear weights, and
// ty, tx, the mask and 1 where the sample counts (else 0)
struct Corners {
  int4 idx;
  float4 w;
  float4 tym;
};

// (from its offsets dy, dx and mask mk there)
__device__ __forceinline__ Corners corners_at(int m, int t, float dy, float dx, float mk, int H,
                                              int W, int C, int OH, int OW, int stride) {
  const int b = m / (OH * OW);
  const int r = m - b * (OH * OW);
  const int oy = r / OW;
  const int ox = r - oy * OW;
  const float py = (float)(oy * stride - 1 + t / 3) + dy;
  const float px = (float)(ox * stride - 1 + t % 3) + dx;
  int4 idx = make_int4(-1, -1, -1, -1);
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 tym = make_float4(0.f, 0.f, mk, 0.f);
  // some corner lies inside iff -1 <= py < H and -1 <= px < W (NaN fails);
  // at py == -1 the sample is 0 but its slope is not
  if (py >= -1.f && px >= -1.f && py < (float)H && px < (float)W) {
    const float fy = floorf(py);
    const float fx = floorf(px);
    const int y0 = (int)fy;
    const int x0 = (int)fx;
    const float ty = py - fy;
    const float tx = px - fx;
    const int p00 = (b * H + y0) * W + x0;  // pixel of corner (0, 0)
    if (y0 >= 0 && x0 >= 0) { idx.x = p00 * C; w.x = (1.f - ty) * (1.f - tx); }
    if (y0 >= 0 && x0 + 1 < W) { idx.y = (p00 + 1) * C; w.y = (1.f - ty) * tx; }
    if (y0 + 1 < H && x0 >= 0) { idx.z = (p00 + W) * C; w.z = ty * (1.f - tx); }
    if (y0 + 1 < H && x0 + 1 < W) { idx.w = (p00 + W + 1) * C; w.w = ty * tx; }
    tym = make_float4(ty, tx, tym.z, 1.f);
  }
  return Corners{idx, w, tym};
}

__device__ __forceinline__ Corners corners_of(int m, int t, const float* __restrict__ off_y,
                                              const float* __restrict__ off_x,
                                              const float* __restrict__ mask, int H, int W,
                                              int C, int OH, int OW, int stride) {
  const int o = m * TAPS + t;
  return corners_at(m, t, off_y[o], off_x[o], mask[o], H, W, C, OH, OW, stride);
}

__global__ void __launch_bounds__(THREADS)
dcn_col2im_kernel(const float* __restrict__ x,       // [B, H, W, C]
                  const float* __restrict__ off_y,   // [B, OH, OW, 9]
                  const float* __restrict__ off_x,   // [B, OH, OW, 9]
                  const float* __restrict__ mask,    // [B, OH, OW, 9]
                  const float* __restrict__ dcols,   // [B*OH*OW, 9*C]
                  float* __restrict__ dx,            // [B, H, W, C], zeroed
                  float* __restrict__ doff_y,        // [B, OH, OW, 9]
                  float* __restrict__ doff_x,        // [B, OH, OW, 9]
                  float* __restrict__ dmask,         // [B, OH, OW, 9]
                  int B, int H, int W, int C, int OH, int OW, int stride) {
  __shared__ Tables s;
  const int M = B * OH * OW;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0) * TAPS;

  // phase 1: the tables, one (pixel, tap) per thread at a time
  for (int e = threadIdx.x; e < rows; e += THREADS) {
    const int mi = e / TAPS;
    const Corners k = corners_of(m0 + mi, e - mi * TAPS, off_y, off_x, mask, H, W, C, OH, OW,
                                 stride);
    s.idx[e] = k.idx;
    s.w[e] = k.w;
    s.tym[e] = k.tym;
  }
  __syncthreads();

  // phase 2: one warp per row; row e of the block is row m0 * 9 + e of dcols
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int e = warp; e < rows; e += WARPS) {
    const int64_t mt = (int64_t)m0 * TAPS + e;
    const float4 tym = s.tym[e];
    if (tym.w == 0.f) {  // no corner counts: every gradient of the row is 0
      if (lane == 0) doff_y[mt] = doff_x[mt] = dmask[mt] = 0.f;
      continue;
    }
    const int4 idx = s.idx[e];
    const float4 w = s.w[e];
    const float ty = tym.x, tx = tym.y, mk = tym.z;
    const float* grow = dcols + mt * C;
    float s_m = 0.f, s_y = 0.f, s_x = 0.f;
#pragma unroll 2
    for (int c = 4 * lane; c < C; c += 4 * 32) {
      const float4 g = __ldcs(reinterpret_cast<const float4*>(grow + c));
      const float4 v00 = corner(x, idx.x, c);
      const float4 v01 = corner(x, idx.y, c);
      const float4 v10 = corner(x, idx.z, c);
      const float4 v11 = corner(x, idx.w, c);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float a00[4] = {v00.x, v00.y, v00.z, v00.w};
      const float a01[4] = {v01.x, v01.y, v01.z, v01.w};
      const float a10[4] = {v10.x, v10.y, v10.z, v10.w};
      const float a11[4] = {v11.x, v11.y, v11.z, v11.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_m += gv[k] * (w.x * a00[k] + w.y * a01[k] + w.z * a10[k] + w.w * a11[k]);
        s_y += gv[k] * ((1.f - tx) * (a10[k] - a00[k]) + tx * (a11[k] - a01[k]));
        s_x += gv[k] * ((1.f - ty) * (a01[k] - a00[k]) + ty * (a11[k] - a10[k]));
      }
      const float4 gm = make_float4(g.x * mk, g.y * mk, g.z * mk, g.w * mk);
      if (idx.x >= 0) red4(dx + idx.x + c, w.x, gm);
      if (idx.y >= 0) red4(dx + idx.y + c, w.y, gm);
      if (idx.z >= 0) red4(dx + idx.z + c, w.z, gm);
      if (idx.w >= 0) red4(dx + idx.w + c, w.w, gm);
    }
    s_m = warp_sum(s_m);
    s_y = warp_sum(s_y);
    s_x = warp_sum(s_x);
    if (lane == 0) {
      dmask[mt] = s_m;
      doff_y[mt] = mk * s_y;
      doff_x[mt] = mk * s_x;
    }
  }
}



// ---------------------------------------------------------------- bf16

namespace gw {

constexpr int TM = 64;          // pixels a unit: one m64 wgmma
constexpr int TN = 256;         // channels a part: one n256 wgmma
constexpr int TK = 64;          // K tile: 64 output channels of g (the tail 16, 32 or 48)
constexpr int STAGES = 2;       // ring depth
constexpr int S_WARPS = 8;      // scatter warps, after the MMA warpgroup
constexpr int THREADS = 128 + 32 * S_WARPS;
// pixels of a unit a scatter warp owns, at most
constexpr int WARP_ROWS = (TM + S_WARPS - 1) / S_WARPS;
constexpr int ST_STRIDE = TN + 8;   // staging row (fp32): conflict-free 8-byte stores

// one ring stage: the prepared weight tile (256 channels x D k, wgmma's
// K-major core matrices: 8 rows x 16 bytes, 128 bytes apart along k, D *
// 16 along n) and the g tile (64 rows of 128 bytes in the 128-byte swizzle)
struct alignas(1024) Stage {
  __nv_bfloat16 b[TN * TK];
  __nv_bfloat16 a[TM * TK];
};

// a scatter warp's (pixel, tap) row: its corners, and its dmask, doff_y and
// doff_x sums over the unit's parts so far (x, y, z)
struct Row {
  Corners k;
  float4 sum;
};

struct Smem {
  Stage st[STAGES];
  float stg[2][TM][ST_STRIDE];  // a part's dcols, two in flight
  Row row[S_WARPS][WARP_ROWS];
  uint64_t full[STAGES];   // the stage's copies: the weight tile's bytes, one arrival
  uint64_t stg_full[2];    // the MMA warpgroup's 128 threads have stored the part
  uint64_t stg_empty[2];   // the scatter warps are done with it
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;  // and the alignment of its base

// 16 bytes global -> shared, zero-filled past `bytes` (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// weight [9C, Cout] fp32 -> bf16 (nearest even), per tap t and 256-channel
// part nb one chunk of 256 x Cout at (t * NB + nb) * 256 * Cout, in K tiles
// (k0, depth D = min(64, Cout - k0)) of 256 x D at k0 * 256, core matrix
// (channel group ng, k group kg) at (ng * D/8 + kg) * 64, element (channel
// r, k q) of it at r * 8 + q; zeros past C
__global__ void weight_prep_kernel(const float* __restrict__ weight,
                                   __nv_bfloat16* __restrict__ prep, int C, int Cout, int NB,
                                   int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t chunk = (int64_t)TN * Cout;
  const int tnb = (int)(i / chunk);
  const int rem = (int)(i % chunk);
  const int t = tnb / NB;
  const int k0 = rem / (TK * TN) * TK;
  const int D = min(TK, Cout - k0);
  const int within = rem - k0 * TN;
  const int c = tnb % NB * TN + within / (D * 8) * 8 + within % 64 / 8;
  const int k = k0 + within % (D * 8) / 64 * 8 + within % 8;
  prep[i] = __float2bfloat16_rn(c < C ? weight[((int64_t)t * C + c) * Cout + k] : 0.f);
}

// A block's units: first, first + step, ..., count of them
struct Units {
  int first, step, count;
  __device__ __forceinline__ int operator[](int j) const { return first + j * step; }
};

// The MMA warpgroup: for each of the block's units and each part nb of it,
// the part's dcols [64 px, 256 ch] = g tile [64, Cout] x (prepared weight
// of tap t, part nb) [Cout, 256], one fp32 accumulator over all of Cout,
// stored into staging tile (part count) & 1. Step i (unit, part, K tile)
// has its copies in stage i % STAGES, issued STAGES - 1 steps ahead
__device__ __forceinline__ void multiply(Smem& s, const __nv_bfloat16* __restrict__ g,
                                         const __nv_bfloat16* __restrict__ wprep, Units units,
                                         int M, int Cout, int NB, int tid) {
  const int KT = (Cout + TK - 1) / TK;
  const int per_unit = NB * KT;
  const int steps = units.count * per_unit;
  // this thread's 16-byte pieces of step i's g tile, and one thread's bulk
  // copy of its weight tile; past the last step an empty group, so that
  // every step commits one
  auto issue = [&](int i) {
    if (i < steps) {
      const int u = units[i / per_unit];
      const int nb = i % per_unit / KT;
      const int k0 = i % KT * TK;
      const int D = min(TK, Cout - k0);
      const int m0 = u / TAPS * TM;
      Stage& sg = s.st[i % STAGES];
      const int chunks = D / 8;
      for (int e = tid; e < TM * chunks; e += 128) {
        const int r = e / chunks;
        const int c = e - r * chunks;
        const int m = m0 + r;
        cp_async16(&sg.a[r * TK + (c ^ (r & 7)) * 8],
                   g + (int64_t)min(m, M - 1) * Cout + k0 + c * 8, m < M ? 16 : 0);
      }
      if (tid == 0) {
        const uint32_t bytes = TN * D * (uint32_t)sizeof(__nv_bfloat16);
        mbar_arrive_expect_tx(&s.full[i % STAGES], bytes);
        bulk_copy(sg.b, wprep + ((int64_t)(u % TAPS * NB + nb) * Cout + k0) * TN, bytes,
                  &s.full[i % STAGES]);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  float acc[128];  // the first wgmma of each part ignores their values
  int part = 0;
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < steps; ++i) {
    // step i's g tile has landed (this thread's pieces, then everyone's,
    // seen by the wgmmas' async-proxy reads); every thread is past step
    // i-1's wgmmas, so their stage takes step i + STAGES - 1's copies
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    issue(i + STAGES - 1);
    const int kt = i % KT;
    const int D = min(TK, Cout - kt * TK);
    Stage& sg = s.st[i % STAGES];
    mbar_wait(&s.full[i % STAGES], (i / STAGES) & 1);
    // k16 step ks: A 32 bytes on in its swizzled rows, B two core
    // matrices (256 bytes) on (descriptor addresses count 16 bytes)
    const uint64_t da = sw128_desc(sg.a);
    const uint64_t db = smem_desc(sg.b, 128, D * 16);
    wgmma_fence();
    wgmma_m64n256k16(acc, da, db, kt > 0);
    if (D > 16) wgmma_m64n256k16(acc, da + 2, db + 16, 1);
    if (D > 32) wgmma_m64n256k16(acc, da + 4, db + 32, 1);
    if (D > 48) wgmma_m64n256k16(acc, da + 6, db + 48, 1);
    wgmma_commit();
    wgmma_wait<0>();
    if (kt + 1 < KT) continue;
    // the part's dcols into its staging tile, once the scatter warps are
    // done with the part two before
    const int sb = part & 1;
    mbar_wait(&s.stg_empty[sb], ((part >> 1) & 1) ^ 1);
    float(*st)[ST_STRIDE] = s.stg[sb];
    const int r = warp * 16 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      *reinterpret_cast<float2*>(&st[r][8 * j + c]) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&st[r + 8][8 * j + c]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    mbar_arrive(&s.stg_full[sb]);
    ++part;
  }
}

// A row's corner values for lane l: channels 4l .. 4l+3 of each 128-channel
// half of part nb, corners (0,0), (0,1), (1,0), (1,1); zeros outside the
// image, past C, or for a row that does not count
__device__ __forceinline__ void load_row(uint2 (&v)[2][4], const Corners& k, bool live,
                                         const __nv_bfloat16* __restrict__ x, int nb, int C,
                                         int lane) {
  const int idx[4] = {k.idx.x, k.idx.y, k.idx.z, k.idx.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = nb * TN + h * (TN / 2) + 4 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[h][j] = live && c < C && idx[j] >= 0
                    ? __ldg(reinterpret_cast<const uint2*>(x + idx[j] + c))
                    : make_uint2(0u, 0u);
  }
}

// A scatter warp: pixels sw, sw + S_WARPS, ... (its rows) of each of the
// block's units. Per unit, lane r < WARP_ROWS builds row r's corners at the unit's
// tap from offsets fetched a unit ahead; per part, one row at a time with
// the corner loads of the next PF rows in flight, lane l takes channels 4l
// .. 4l+3 of each 128-channel half; the rows' three sums go through the
// warp's shuffles together at the part's end
constexpr int PF = 2;

__device__ __forceinline__ void scatter(Smem& s, const __nv_bfloat16* __restrict__ x,
                                        const float* __restrict__ off_y,
                                        const float* __restrict__ off_x,
                                        const float* __restrict__ mask, float* __restrict__ dx,
                                        float* __restrict__ doff_y, float* __restrict__ doff_x,
                                        float* __restrict__ dmask, Units units, int M, int H,
                                        int W, int C, int OH, int OW, int stride, int NB, int sw,
                                        int lane) {
  Row* rows = s.row[sw];
  // lane < WARP_ROWS: its row's offsets and mask, a unit ahead
  float fy = 0.f, fx = 0.f, fm = 0.f;
  auto fetch = [&](int j) {
    const int u = units[j];
    const int p = sw + lane * S_WARPS;
    const int m = u / TAPS * TM + p;
    if (j < units.count && lane < WARP_ROWS && p < TM && m < M) {
      const int o = m * TAPS + u % TAPS;
      fy = off_y[o];
      fx = off_x[o];
      fm = mask[o];
    }
  };
  fetch(0);
  int part = 0;
  for (int j = 0; j < units.count; ++j) {
    const int u = units[j];
    const int m0 = u / TAPS * TM;
    const int t = u % TAPS;
    // this warp's rows in the unit: those of its pixels before M
    const int lim = min(TM, M - m0) - sw;
    const int n = lim > 0 ? min(WARP_ROWS, (lim + S_WARPS - 1) / S_WARPS) : 0;
    __syncwarp();  // done with the last unit's rows
    if (lane < n) {
      rows[lane] = Row{corners_at(m0 + sw + lane * S_WARPS, t, fy, fx, fm, H, W, C, OH, OW,
                                  stride),
                       make_float4(0.f, 0.f, 0.f, 0.f)};
    }
    fetch(j + 1);
    __syncwarp();
    for (int nb = 0; nb < NB; ++nb, ++part) {
      const int sb = part & 1;
      mbar_wait(&s.stg_full[sb], (part >> 1) & 1);
      const float(*st)[ST_STRIDE] = s.stg[sb] + sw;  // row r at st[r * S_WARPS]
      uint2 v[WARP_ROWS][2][4];
      float sm[WARP_ROWS], sy[WARP_ROWS], sx[WARP_ROWS];
#pragma unroll
      for (int r = 0; r < PF; ++r)
        load_row(v[r], rows[r].k, r < n && rows[r].k.tym.w != 0.f, x, nb, C, lane);
#pragma unroll
      for (int r = 0; r < WARP_ROWS; ++r) {
        if (r + PF < WARP_ROWS) {
          load_row(v[r + PF], rows[r + PF].k, r + PF < n && rows[r + PF].k.tym.w != 0.f, x, nb,
                   C, lane);
        }
        sm[r] = sy[r] = sx[r] = 0.f;
        const Corners k = rows[r].k;
        if (r >= n || k.tym.w == 0.f) continue;  // no corner counts: the row's gradients are 0
        const float ty = k.tym.x, tx = k.tym.y, mk = k.tym.z;
        const float4 w = k.w;
        const int idx[4] = {k.idx.x, k.idx.y, k.idx.z, k.idx.w};
        const float wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = h * (TN / 2) + 4 * lane;  // column of the part
          const int c = nb * TN + cl;              // channel
          if (c >= C) continue;
          const float4 g = *reinterpret_cast<const float4*>(&st[r * S_WARPS][cl]);
          const float4 v00 = widen4(v[r][h][0]);
          const float4 v01 = widen4(v[r][h][1]);
          const float4 v10 = widen4(v[r][h][2]);
          const float4 v11 = widen4(v[r][h][3]);
          const float gv[4] = {g.x, g.y, g.z, g.w};
          const float a00[4] = {v00.x, v00.y, v00.z, v00.w};
          const float a01[4] = {v01.x, v01.y, v01.z, v01.w};
          const float a10[4] = {v10.x, v10.y, v10.z, v10.w};
          const float a11[4] = {v11.x, v11.y, v11.z, v11.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm[r] += gv[e] * (w.x * a00[e] + w.y * a01[e] + w.z * a10[e] + w.w * a11[e]);
            sy[r] += gv[e] * ((1.f - tx) * (a10[e] - a00[e]) + tx * (a11[e] - a01[e]));
            sx[r] += gv[e] * ((1.f - ty) * (a01[e] - a00[e]) + ty * (a11[e] - a10[e]));
          }
          const float4 gm = make_float4(g.x * mk, g.y * mk, g.z * mk, g.w * mk);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (idx[j] >= 0) red4(dx + idx[j] + c, wj[j], gm);
        }
      }
      // each row's sums in warp_sum's order, the rows' shuffles interleaved
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < WARP_ROWS; ++r) {
          sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], o);
          sy[r] += __shfl_xor_sync(0xffffffffu, sy[r], o);
          sx[r] += __shfl_xor_sync(0xffffffffu, sx[r], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < WARP_ROWS; ++r) {
          const float4 a = rows[r].sum;
          rows[r].sum = make_float4(a.x + sm[r], a.y + sy[r], a.z + sx[r], 0.f);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.stg_empty[sb]);
    }
    __syncwarp();
    if (lane < n) {
      const Row rw = rows[lane];
      const int64_t mt = (int64_t)(m0 + sw + lane * S_WARPS) * TAPS + t;
      const bool live = rw.k.tym.w != 0.f;
      dmask[mt] = live ? rw.sum.x : 0.f;
      doff_y[mt] = live ? rw.k.tym.z * rw.sum.y : 0.f;
      doff_x[mt] = live ? rw.k.tym.z * rw.sum.z : 0.f;
    }
  }
}

// Persistent: of the U = ceil(M / 64) * 9 (64-pixel tile, tap) units,
// block i walks units i, i + G, i + 2G, ..., so that the G blocks sweep the
// image together and the dx lines their adds hit stay few (in the L2).
// Warps 0-3 multiply, the S_WARPS after them scatter.
__global__ void __launch_bounds__(THREADS, 1)
dcn_col2im_gw_kernel(const __nv_bfloat16* __restrict__ x,      // [B, H, W, C]
                     const float* __restrict__ off_y,          // [B, OH, OW, 9]
                     const float* __restrict__ off_x,          // [B, OH, OW, 9]
                     const float* __restrict__ mask,           // [B, OH, OW, 9]
                     const __nv_bfloat16* __restrict__ g,      // [B*OH*OW, Cout]
                     const __nv_bfloat16* __restrict__ wprep,  // prepared weight
                     float* __restrict__ dx,                   // [B, H, W, C], zeroed
                     float* __restrict__ doff_y,               // [B, OH, OW, 9]
                     float* __restrict__ doff_x,               // [B, OH, OW, 9]
                     float* __restrict__ dmask,                // [B, OH, OW, 9]
                     int B, int H, int W, int C, int OH, int OW, int Cout, int stride, int U,
                     int G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles want 1024-byte boundaries (SMEM_BYTES leaves room);
  // offset from the shared array itself, so that every access stays in the
  // shared space
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int M = B * OH * OW;
  const int NB = (C + TN - 1) / TN;
  const Units units{(int)blockIdx.x, G, (U - (int)blockIdx.x + G - 1) / G};
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&s.full[i], 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.stg_full[i], 128);
      mbar_init(&s.stg_empty[i], S_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the two roles part here for the rest of the kernel (the warpgroup,
  // provably uniform across the warp)
  if (__shfl_sync(0xffffffffu, warp, 0) >= 4) {
    scatter(s, x, off_y, off_x, mask, dx, doff_y, doff_x, dmask, units, M, H, W, C, OH, OW,
            stride, NB, warp - 4, threadIdx.x & 31);
  } else {
    multiply(s, g, wprep, units, M, Cout, NB, threadIdx.x);
  }
}

}  // namespace gw

}  // namespace

// dx (fp32) must be zeroed by the caller (the kernel adds into it). The one
// check of the arguments: C a multiple of 4, stride at least 1, x, dcols
// and dx on 16-byte boundaries; anything else returns
// cudaErrorInvalidValue, which the wrapper raises.
extern "C" int dcn_col2im(const void* x, const void* off_y, const void* off_x,
                          const void* mask, const void* dcols, void* dx,
                          void* doff_y, void* doff_x, void* dmask, int B,
                          int H, int W, int C, int OH, int OW, int stride,
                          void* stream) {
  if (C < 4 || C % 4 != 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dcols | (uintptr_t)dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t pixels = (int64_t)B * OH * OW;
  if (pixels == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((pixels + BM - 1) / BM);
  dcn_col2im_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<const float*>(dcols), static_cast<float*>(dx),
      static_cast<float*>(doff_y), static_cast<float*>(doff_x),
      static_cast<float*>(dmask), B, H, W, C, OH, OW, stride);
  return (int)cudaGetLastError();
}

// The DCN backward's sampling half on a bf16 x from the bf16 output
// gradient g [B*OH*OW, Cout] and the fp32 weight [9C, Cout], which the
// prep kernel rounds to bf16 once into wprep: scratch of 9 * ceil(C / 256)
// * 256 * Cout bf16. dx is the zeroed fp32 workspace; d offsets and dmask
// fp32. The one check of the arguments: C a multiple of 4, Cout of 16,
// stride at least 1, x on an 8-byte boundary, g, wprep and dx on 16-byte
// ones; anything else returns cudaErrorInvalidValue, which the wrapper
// raises. One block an SM, at most one a unit.
extern "C" int dcn_col2im_gw(const void* x, const void* off_y, const void* off_x,
                             const void* mask, const void* g, const void* weight, void* wprep,
                             void* dx, void* doff_y, void* doff_x, void* dmask, int B, int H,
                             int W, int C, int OH, int OW, int Cout, int stride, void* stream) {
  if (C < 4 || C % 4 != 0 || Cout < 16 || Cout % 16 != 0 || stride < 1)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 != 0 || ((uintptr_t)g | (uintptr_t)wprep | (uintptr_t)dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int M = B * OH * OW;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (C + gw::TN - 1) / gw::TN;
  const int64_t total = (int64_t)TAPS * nb * gw::TN * Cout;
  gw::weight_prep_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(weight), static_cast<__nv_bfloat16*>(wprep), C, Cout, nb, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int units = (M + gw::TM - 1) / gw::TM * TAPS;
  const int G = min(sms, units);
  e = cudaFuncSetAttribute(gw::dcn_col2im_gw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           gw::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  gw::dcn_col2im_gw_kernel<<<G, gw::THREADS, gw::SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(wprep),
      static_cast<float*>(dx), static_cast<float*>(doff_y), static_cast<float*>(doff_x),
      static_cast<float*>(dmask), B, H, W, C, OH, OW, Cout, stride, units, G);
  return (int)cudaGetLastError();
}
