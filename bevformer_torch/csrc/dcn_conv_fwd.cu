// DCNv2 (modulated deformable 3x3 conv) forward as an implicit GEMM on the
// tensor cores, for Hopper (sm_90a).
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
// What bounds it on this card: the contraction. A bevformer_base stage-3
// call is 41 GFLOP (M = 6*58*100 pixels, K = 9*256, N = 256), stage 4 the
// same (M = 6*29*50, K = 9*512, N = 512), against 77 MB of inputs and
// outputs. The port computes in fp32, and a single TF32 product (10-bit
// mantissas) misses its 1e-4 tolerance at K = 2304. So the product runs on
// the tensor cores as 3xTF32: each operand is split into big = rna(a) and
// small = rna(a - big) (cvt.rna.tf32.f32, never the tensor core's truncation
// of raw fp32 bits), and small*big' + big*small' + big*big' is accumulated
// in fp32, which keeps fp32's accuracy at three TF32 products per
// multiply-add: 165 TFLOP/s of the card's 495 TF32, 2.5x the 67 TFLOP/s of
// the fp32 SIMT units.
//
// The tensor cores round each accumulation toward zero, not to nearest: one
// accumulator carried over all of K = 9*512 drifts by ~4e-5 of the output's
// scale on the card (tests/test_torch_dcn_tf32.py emulates it). So each
// 32-deep K tile is summed into fresh MMA accumulators (the tile's first
// wgmma ignores their old value), which are then added to the block's fp32
// accumulators by ordinary round-to-nearest adds: the error is that of fp32
// sums again.
//
// What the design does about it:
// - wgmma (m64n64k8, .tf32), Hopper's asynchronous warpgroup MMA: on this
//   card mma.sync's TF32 rate left three products per multiply-add slower
//   than wgmma by ~1.7x at stage 3. TF32 wgmma takes B K-major from shared
//   memory, and the weight arrives N-major ([9C, Cout] row-major); so a prep
//   kernel (one pass over the 2.4-9.4 MB weight, into a scratch buffer that
//   the wrapper allocates) writes its big and small halves in the layout the
//   wgmma descriptor reads: per 256-column block and 32-deep K tile, 8 x 4
//   core matrices of 8 columns x 4 k (128 bytes each; the k-neighbour 128
//   bytes on, the n-neighbour 1024), zeros past Cout. A comes from
//   registers, in mma.m16n8k8's fragment layout.
// - A block owns 64 pixels x 256 output channels (all of stage 3's, half of
//   stage 4's), so each column tile is sampled once (twice at stage 4),
//   not Cout/64 times: ~1.3 GB of corner reads per call instead of ~5.1.
//   Four warpgroups take 64 columns each: 32 MMA accumulators for the K
//   tile and 32 fp32 accumulators per thread.
// - Each 32-deep K tile lies in one tap (C is a multiple of 32). The
//   block's per-pixel corner tables (element offset of each of the 4
//   bilinear corners, -1 outside, and its weight x mask) are built once per
//   block for the 9 taps. Sampling keeps lane = channel, so each corner is
//   one coalesced 128-byte read of the channels-last input. The sampled
//   value is split once, as it is written to shared memory ({big, small}
//   pairs, one 8-byte load per A-fragment element).
// - The column and weight tiles are double-buffered. At the top of K tile
//   kt, one barrier; then the weight tile kt+1 (big and small, 64 KB) goes
//   out by cp.async and this thread's 16 corner loads of column tile kt+1
//   are issued into registers, both before the 12 wgmmas of tile kt; after
//   them, the corners are combined into the next column buffer. One block
//   of 512 threads per SM (183 KB of dynamic shared memory).
// - Ragged M and Cout are masked (rows past M sample nothing, the prepared
//   weight is zero past Cout, stores are guarded).
//
// bf16 (`dcn_conv_fwd_bf16`, the counterpart of _kernel_conv_rc at
// compute_dtype=bfloat16: a bf16 x, the sampled column rounded to bf16 in
// smp_ref, a bf16 product with fp32 sums, the output rounded to bf16). The
// column is the plain version's bitwise (kernels/dcn.py::dcn_conv_plain):
// each corner times its bilinear weight, summed in the order (0,0), (0,1),
// (1,0), (1,1), times the mask, with no FMA, rounded once to bf16. A prep
// kernel rounds the fp32 weight [9C, Cout] once to bf16, per 256-column
// block and K tile into one contiguous chunk in wgmma's K-major core
// matrices.
//
// What bounds it on this card: the sampling. A stage-3 call of
// bevformer_base is 41 GFLOP, 42 us at the card's 989 TFLOP/s dense bf16,
// but its column is 80 M values, each from four 2-byte corner reads (641
// MB gathered from the L2 in 8-byte pieces) and ~12 fp32 operations. The
// first bf16 kernel sampled in lockstep with its wgmmas (512 threads an
// SM, 64 x 256 tiles, 32-deep K tiles) and took 0.400 ms a stage-3 call
// and 0.458-0.462 a stage-4 one (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): the tensor cores sat idle while it sampled.
//
// What the design does about it:
// - Persistent and warp-specialised: one block of 384 threads an SM. Warps
//   4-11 only sample; warps 0-3, one warpgroup, only issue wgmma
//   (m64n256k16, A and B from shared memory through descriptors). They
//   meet in a ring of 4 stages in shared memory (40 KB each: a 64 x 64
//   column tile and the 256 x 64 weight tile), each with a full and an
//   empty mbarrier; nothing in the main loop waits on __syncthreads.
// - The grid: ceil(Cout / 256) column blocks, each over G = SMs / blocks
//   of them (at least 64 pixels each) contiguous pixel ranges, so that
//   base's 34800 stage-3 pixels are 263-264 per SM, not whole tiles
//   unevenly spread; each block walks its range in 64-pixel tiles. A
//   sampling warp whose pixels all lie past its block's range (a range's
//   last tile) skips their loads and stores: those rows feed no output.
// - The sampling warps: each owns 8 pixels of a tile, and a lane takes 2
//   of them at 8 channels, each corner in two 8-byte loads (x need only
//   lie on an 8-byte boundary), so a warp's corner loads read 4 pixels'
//   whole 128-byte rows, and its store is one 16-byte row of the column
//   tile in the 128-byte swizzle (conflict-free). The next K tile's 16
//   corner loads are in flight while this one's are combined; the corner
//   tables (offsets, weights, mask) are built once per (pixel, tap) from
//   offsets fetched a tap ahead. One lane of warp 4 brings each weight
//   tile in by one 1-D bulk copy (cp.async.bulk) that completes on the
//   stage's full barrier; the warps' shared-memory writes reach the wgmmas
//   through fence.proxy.async.
// - The consumer keeps one wgmma group in flight and releases a stage as
//   soon as its group has retired; one fp32 accumulator over the whole K
//   (tests/test_torch_dcn_bf16_mma.py: its truncating sums drift 8e-6 of
//   scale at K = 4608, a thousandth of a bf16 ulp); the output is rounded
//   once and stored through shared memory in 16-byte rows while the
//   sampling warps fill the next tile's stages.
// - Why 64-pixel tiles and one consumer warpgroup: ptxas allocates every
//   warp within the launch's registers (C7602 at 512 threads: 128 a thread,
//   too few for the 128 accumulators of an m64n256 wgmma), so setmaxnreg
//   has nothing to move, and at 384 threads each warp has 168. Two
//   consumer warpgroups (128 x 256 tiles, half the weight traffic) leave
//   one sampling warpgroup, which was slower in this kernel's trials.
// Measured (tools/bench_dcn_variants.py, NVIDIA H100 80GB HBM3, 700.00 W,
// offsets N(0, 3) px): 0.196-0.197 ms a base stage-3 call, 0.216 a stage-4
// one (21% and 19% of the bound; K5 bf16 + one bf16 cuBLAS product, the
// yardstick, in PERF.md section 6); small's 0.121 and 0.145-0.146. The
// sampling warps' instruction stream (8 warps on 4 schedulers: the corner
// loads and their sums, the ring's barriers and bookkeeping) bounds it,
// not the tensor cores: so the corner tables
// hold byte offsets (one add a load), and a pixel's place is divided out
// once a tile, not once a tap. A stage-4 call samples each pixel twice,
// once per column block. Measured beside it in one run and not kept: one
// 16-byte load a corner (2.3-3.2% faster, a second instantiation for a
// 16-byte x), the proxy fence taken once by the consumer after its
// full-barrier wait (0.8-1.6% faster; the fence stays with the writers,
// as CUTLASS places it, since the reader-side order is not documented).
// The JAX kernel also rounds its bilinear x-weights to bf16 (it samples by
// a one-hot matmul); here they stay fp32, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int BM = 64;    // pixels per block
constexpr int BN = 256;   // output channels per block
constexpr int BK = 32;    // K tile (within one tap)
constexpr int TAPS = 9;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int WG_N = 64;                 // columns per warpgroup
constexpr int PX = BM / WARPS;           // pixels each warp samples per K tile
constexpr int A_STRIDE = BK + 4;         // uint2: 8-byte A-fragment loads hit 32 banks per half-warp
constexpr int B_TILE = BN * BK;          // floats of one prepared weight tile
constexpr int CORE = 32;                 // floats of one 8 x 4 core matrix
constexpr uint32_t CORE_K_BYTES = 128;   // descriptor: to the next core matrix along k
constexpr uint32_t CORE_N_BYTES = 1024;  // descriptor: to the next core matrix along n

struct Smem {
  uint2 a[2][BM][A_STRIDE];  // sampled column tiles [pixel][k], {big, small} TF32
  float big[2][B_TILE];      // weight tiles, core-matrix order, TF32 big halves
  float small[2][B_TILE];    // and small halves
  int idx[TAPS][4][BM];      // corner element offset into x, -1 if outside
  float w[TAPS][4][BM];      // bilinear weight * mask
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small to ~fp32 accuracy, each a TF32 value
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// descriptor of a weight tile's core matrices (sm90_wgmma.cuh::smem_desc)
__device__ __forceinline__ uint64_t core_desc(const void* p) {
  return smem_desc(p, CORE_K_BYTES, CORE_N_BYTES);
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d [64 x 64] = a [64 x 8] (registers) * b [8 x 64] (descriptor) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_64x64x8(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// weight [K, Cout] -> per (256-column block nb, K tile kt) one B_TILE chunk
// at (nb * K/BK + kt) * B_TILE, core matrix (ng, kg) at (ng * 8 + kg) * CORE,
// element (column r, k q) of it at r * 4 + q; zeros past Cout
__global__ void dcn_weight_prep_kernel(const float* __restrict__ weight,
                                       float* __restrict__ big, float* __restrict__ small,
                                       int K, int Cout, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int q = (int)(i & 3);
  const int r = (int)((i >> 2) & 7);
  const int kg = (int)((i >> 5) & 7);
  const int ng = (int)((i >> 8) & 31);
  const int64_t tile = i >> 13;  // nb * (K / BK) + kt
  const int kt = (int)(tile % (K / BK));
  const int nb = (int)(tile / (K / BK));
  const int n = nb * BN + ng * 8 + r;
  const int k = kt * BK + kg * 4 + q;
  uint32_t b, s;
  split(n < Cout ? weight[(int64_t)k * Cout + n] : 0.f, b, s);
  big[i] = __uint_as_float(b);
  small[i] = __uint_as_float(s);
}

// this thread's corner values of one column tile: pixels warp + WARPS*i,
// channel c of tap t
__device__ __forceinline__ void load_corners(float (&v)[PX][4], const Smem& s,
                                             const float* __restrict__ x, int t, int c,
                                             int warp) {
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int mi = warp + i * WARPS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int id = s.idx[t][j][mi];
      v[i][j] = id >= 0 ? __ldg(x + id + c) : 0.f;
    }
  }
}

// the column values, each split once into its TF32 pair
__device__ __forceinline__ void store_column(uint2 (*as)[A_STRIDE], const float (&v)[PX][4],
                                             const Smem& s, int t, int lane, int warp) {
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int mi = warp + i * WARPS;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) a += s.w[t][j][mi] * v[i][j];
    uint2 pair;
    split(a, pair.x, pair.y);
    as[mi][lane] = pair;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
dcn_conv_fwd_kernel(const float* __restrict__ x,      // [B, H, W, C]
                    const float* __restrict__ off_y,  // [B, OH, OW, 9]
                    const float* __restrict__ off_x,  // [B, OH, OW, 9]
                    const float* __restrict__ mask,   // [B, OH, OW, 9]
                    const float* __restrict__ wbig,   // prepared weight, big halves
                    const float* __restrict__ wsmall, // and small halves
                    float* __restrict__ out,          // [B, OH, OW, Cout]
                    int B, int H, int W, int C, int OH, int OW, int Cout,
                    int stride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int M = B * OH * OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KT = TAPS * C / BK;
  const float* gbig = wbig + (int64_t)blockIdx.y * KT * B_TILE;
  const float* gsmall = wsmall + (int64_t)blockIdx.y * KT * B_TILE;
  auto load_weight_tile = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < B_TILE / 4 / THREADS; ++i) {
      const int e = (tid + i * THREADS) * 4;
      cp_async16(&s.big[buf][e], gbig + (int64_t)kt * B_TILE + e);
      cp_async16(&s.small[buf][e], gsmall + (int64_t)kt * B_TILE + e);
    }
  };

  // weight tile 0 travels while the corner tables are built
  load_weight_tile(0, 0);
  cp_async_commit();

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
      s.idx[t][j][mi] = idx[j];
      s.w[t][j][mi] = wt[j];
    }
  }
  __syncthreads();

  float v[PX][4];
  load_corners(v, s, x, 0, lane, warp);
  store_column(s.a[0], v, s, 0, lane, warp);

  const int wg = warp >> 2;  // warpgroup: columns wg*WG_N ..
  const int wr = warp & 3;   // warp in it: rows wr*16 ..
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // fragment thread in group
  float acc[32];             // fp32 sums over the K tiles done
  float part[32];            // the wgmmas' sum over this K tile
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    // weight tile kt has landed and column tile kt is written; every warp
    // is done with tile kt-1, whose buffers now take tile kt+1. The fence
    // shows this thread's copies to the wgmma's (async proxy) reads
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const bool more = kt + 1 < KT;
    const int k1 = (kt + 1) * BK;
    const int t1 = k1 / C;
    if (more) {
      load_weight_tile(kt + 1, cur ^ 1);
      load_corners(v, s, x, t1, k1 % C + lane, warp);
    }
    cp_async_commit();

    const uint2(*as)[A_STRIDE] = s.a[cur];
    // this warpgroup's 64 columns: 8 core-matrix rows of CORE_N_BYTES each
    const float* bbig = &s.big[cur][wg * (WG_N / 8) * 8 * CORE];
    const float* bsmall = &s.small[cur][wg * (WG_N / 8) * 8 * CORE];
    // the tile's small cross products first, then its big ones: each
    // truncated add then lands on a smaller running sum (half the
    // systematic shrink toward zero of interleaving them). k8 step ks reads
    // core matrices 2*ks, 2*ks+1 along k. The A fragments stay in registers
    // until the wgmmas have read them, so the big products reuse them
    const int r = wr * 16 + g;
    uint32_t a_big[BK / 8][4], a_small[BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int c = ks * 8 + tg;
      const uint2 e[4] = {as[r][c], as[r + 8][c], as[r][c + 4], as[r + 8][c + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_big[ks][i] = e[i].x;
        a_small[ks][i] = e[i].y;
      }
      wgmma_fence();
      wgmma_64x64x8(part, a_small[ks], core_desc(bbig + ks * 2 * CORE), ks > 0);
      wgmma_64x64x8(part, a_big[ks], core_desc(bsmall + ks * 2 * CORE), 1);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
      wgmma_64x64x8(part, a_big[ks], core_desc(bbig + ks * 2 * CORE), 1);
    wgmma_commit();
    wgmma_wait_all();
    // round-to-nearest fp32 adds: the wgmmas' own accumulation truncates
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    if (more) store_column(s.a[cur ^ 1], v, s, t1, lane, warp);
  }

  // acc[4j .. 4j+3]: rows g and g+8 of the warp's 16, columns 8j + 2tg, +1
  // of the warpgroup's 64 (mma.m16n8's layout, per 8 columns)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wr * 16 + g + half * 8;
    if (m >= M) continue;
    float* orow = out + (int64_t)m * Cout;
#pragma unroll
    for (int j = 0; j < WG_N / 8; ++j) {
      const int n = n0 + wg * WG_N + 8 * j + 2 * tg;
      if (n < Cout) orow[n] = acc[4 * j + 2 * half];
      if (n + 1 < Cout) orow[n + 1] = acc[4 * j + 2 * half + 1];
    }
  }
}


// ---------------------------------------------------------------- bf16

namespace bf16 {

constexpr int TM = 64;       // pixels a tile: one m64 wgmma
constexpr int TN = 256;      // output channels a tile (= BN, the prep's column block)
constexpr int TK = 64;       // K tile: 64 channels of one tap (32 at an odd C's tail)
constexpr int STAGES = 4;    // ring depth
constexpr int P_WARPS = 8;   // sampling warps, after the consumer warpgroup
constexpr int THREADS = 128 + 32 * P_WARPS;
constexpr int P_PIX = TM / P_WARPS;  // pixels a sampling warp owns: 2 rows of 4
constexpr int EP_STRIDE = 64 + 8;    // epilogue staging row (bf16): conflict-free 4-byte writes

// one ring stage: the prepared weight tile in wgmma's K-major core
// matrices (8 rows x 16 bytes, 128 bytes apart along k, D * 16 bytes apart
// along n, D the stage's depth), and the sampled column tile, 64 rows of
// 128 bytes in the 128-byte swizzle (sw128_desc)
struct alignas(1024) Stage {
  __nv_bfloat16 b[TN * TK];
  __nv_bfloat16 a[TM * TK];
};

// a sampling warp's corners for its 8 pixels at one tap
struct CornerTab {
  int4 off[P_PIX];  // byte offset into x of corners (0,0), (0,1), (1,0), (1,1), unsigned
  float4 w[P_PIX];  // their bilinear weights
  float mk[P_PIX];  // the mask
};

struct Smem {
  Stage st[STAGES];
  __nv_bfloat16 ep[4][16][EP_STRIDE];  // a consumer warp's 16 rows x 64 columns
  CornerTab tab[P_WARPS][2];           // a sampling warp's tables of the two taps in flight
  uint64_t full[STAGES];   // the sampling warps, and the weight copy's bytes
  uint64_t empty[STAGES];  // the consumer warpgroup
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;  // and the alignment of its base

// weight [K, Cout] fp32 -> bf16 (nearest even), per 256-column block nb
// and K tile (k0, depth D: 64 channels of one tap, or 32 at an odd tail)
// one contiguous chunk of 256 x D at (nb * K + k0) * 256, core matrix
// (column group ng, k group kg) at (ng * D/8 + kg) * 64, element (column
// r, k q) of it at r * 8 + q; zeros past Cout
__global__ void weight_prep_kernel(const float* __restrict__ weight,
                                   __nv_bfloat16* __restrict__ prep, int C, int Cout,
                                   int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int K = TAPS * C;
  const int nb = (int)(i / ((int64_t)K * TN));
  const int rem = (int)(i % ((int64_t)K * TN));
  const int kk = rem / TN;  // a k inside this element's chunk
  const int c0 = (kk % C) / TK * TK;
  const int k0 = kk / C * C + c0;
  const int D = min(TK, C - c0);
  const int within = rem - k0 * TN;
  const int ng = within / (D * 8);
  const int kg = within % (D * 8) / 64;
  const int n = nb * TN + ng * 8 + (within % 64) / 8;
  const int k = k0 + kg * 8 + within % 8;
  prep[i] = __float2bfloat16_rn(n < Cout ? weight[(int64_t)k * Cout + n] : 0.f);
}

// 8 bf16 of x in two 8-byte loads (x need only lie on an 8-byte boundary)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
  const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p) + 1);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// 8 column values in the plain version's arithmetic: each corner times its
// weight, summed in corner order with no FMA, times the mask, rounded once
__device__ __forceinline__ uint4 combine8(const uint4 (&v)[4], float4 w, float mk) {
  const float wj[4] = {w.x, w.y, w.z, w.w};
  float a[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a bf16 is the top half of the fp32 of the same value
      a[2 * e] = __fadd_rn(a[2 * e], __fmul_rn(__uint_as_float(u[e] << 16), wj[j]));
      a[2 * e + 1] = __fadd_rn(a[2 * e + 1], __fmul_rn(__uint_as_float(u[e] & 0xffff0000u), wj[j]));
    }
  }
  uint32_t r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(a[2 * e], mk),
                                                   __fmul_rn(a[2 * e + 1], mk));
    r[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The sampling warps' walk. A sampling warp owns 8 pixels of each tile,
// two rows of 4: lane (q, cg) = (lane / 8, lane % 8) takes pixels q and 4 +
// q at the 8 channels cg of the K tile's 64 (the lanes past a 32-deep
// tile's 4 idle), so each corner load of a warp reads 4 pixels' whole
// 128-byte rows. The next K tile's 8 corner loads are in flight while this
// one's are combined and stored, across taps and tiles too; the two taps
// in flight keep their corner tables in tab[0] and tab[1].
struct Cursor {
  int m0, t, c0;
  int taps;  // taps begun: tab[taps & 1] is this tap's table

  // to the next K tile; true if it starts a tap
  __device__ __forceinline__ bool next(int C) {
    c0 += TK;
    if (c0 < C) return false;
    c0 = 0;
    if (++t == TAPS) {
      t = 0;
      m0 += TM;
    }
    ++taps;
    return true;
  }
};

struct Producer {
  Smem& s;
  const __nv_bfloat16* __restrict__ x;
  const float* __restrict__ off_y;
  const float* __restrict__ off_x;
  const float* __restrict__ mask;
  const __nv_bfloat16* __restrict__ wblock;  // this column block's prepared weight
  int me, H, W, C, OH, OW, stride, pw, lane;
  CornerTab* tab;  // this warp's two tables
  Cursor ld, st;   // the K tile loaded last, the next one to store
  int stage = 0;
  uint32_t phase = 0;
  // this lane's pixel's offsets and mask at the tap after the load
  // cursor's, fetched a tap ahead of corners(), which uses them
  float py_next = 0.f, px_next = 0.f, mk_next = 0.f;
  // and its image and place, for the tile at pix_m0
  int pix_m0 = -1, pix_b = 0, pix_oy = 0, pix_ox = 0;

  __device__ __forceinline__ void fetch(int m0, int t) {
    const int m = m0 + pw * P_PIX + lane;
    if (lane < P_PIX && m < me) {
      const int64_t e = (int64_t)m * TAPS + t;
      py_next = off_y[e];
      px_next = off_x[e];
      mk_next = mask[e];
    }
  }

  // lane p < 8: pixel p's corners at the load cursor's tap into tab[i],
  // from what fetch() brought in; then the next tap's fetch. A corner
  // outside the image, or of a pixel outside the block's range, reads its
  // image's first pixel at weight 0: the loads need no predicate, and the
  // product with a finite x adds 0, as the plain version's does
  __device__ __forceinline__ void corners(int i) {
    const int m = ld.m0 + pw * P_PIX + lane;
    const int t = ld.t;
    int o[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float mk = 0.f;
    if (lane < P_PIX && m < me) {
      if (pix_m0 != ld.m0) {
        pix_m0 = ld.m0;
        pix_b = m / (OH * OW);
        pix_oy = m % (OH * OW) / OW;
        pix_ox = m % OW;
      }
      const int b = pix_b, oy = pix_oy, ox = pix_ox;
      const float py = (float)(oy * stride - 1 + t / 3) + py_next;
      const float px = (float)(ox * stride - 1 + t % 3) + px_next;
      mk = mk_next;
      o[0] = o[1] = o[2] = o[3] = (int)(2u * (uint32_t)(b * H * W * C));
      // every corner is outside unless -1 < py < H and -1 < px < W (NaN fails)
      if (py > -1.f && px > -1.f && py < (float)H && px < (float)W) {
        const float fy = floorf(py);
        const float fx = floorf(px);
        const int y0 = (int)fy;
        const int x0 = (int)fx;
        const float ty = py - fy;
        const float tx = px - fx;
        const float cw[4] = {__fmul_rn(1.f - ty, 1.f - tx), __fmul_rn(1.f - ty, tx),
                             __fmul_rn(ty, 1.f - tx), __fmul_rn(ty, tx)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int yy = y0 + (j >> 1);
          const int xx = x0 + (j & 1);
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            o[j] = (int)(2u * (uint32_t)(((b * H + yy) * W + xx) * C));
            wt[j] = cw[j];
          }
        }
      }
    }
    if (t + 1 < TAPS) {
      fetch(ld.m0, t + 1);
    } else {
      fetch(ld.m0 + TM, 0);
    }
    __syncwarp();  // the warp is done with the tap this table held
    if (lane < P_PIX) {
      tab[i].off[lane] = make_int4(o[0], o[1], o[2], o[3]);
      tab[i].w[lane] = make_float4(wt[0], wt[1], wt[2], wt[3]);
      tab[i].mk[lane] = mk;
    }
    __syncwarp();
  }

  // the load cursor's 8 corner loads
  __device__ __forceinline__ void load(uint4 (&v)[2][4]) const {
    const CornerTab& tb = tab[ld.taps & 1];
    const int cg = lane & 7;
    // past a 32-deep tile, or the warp's pixels all past the block's range
    if (cg * 8 >= C - ld.c0 || ld.m0 + pw * P_PIX >= me) return;
    const char* xc = reinterpret_cast<const char*>(x + ld.c0 + cg * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int4 o = tb.off[4 * h + (lane >> 3)];
      const uint32_t oj[4] = {(uint32_t)o.x, (uint32_t)o.y, (uint32_t)o.z, (uint32_t)o.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[h][j] = load8(reinterpret_cast<const __nv_bfloat16*>(xc + oj[j]));
    }
  }

  // the store cursor's K tile, whose loads are v: claim the stage, bring in
  // its weight tile, write the warp's 8 rows of the column tile and hand
  // the stage to the consumers
  __device__ __forceinline__ void store(const uint4 (&v)[2][4]) {
    const int D = min(TK, C - st.c0);
    Stage& sg = s.st[stage];
    mbar_wait(&s.empty[stage], phase ^ 1);
    if (pw == 0 && lane == 0) {
      const uint32_t bytes = TN * D * (uint32_t)sizeof(__nv_bfloat16);
      mbar_arrive_expect_tx(&s.full[stage], bytes);
      bulk_copy(sg.b, wblock + (int64_t)(st.t * C + st.c0) * TN, bytes, &s.full[stage]);
    }
    const CornerTab& tb = tab[st.taps & 1];
    const int cg = lane & 7;
    // rows past the block's range feed only outputs that are not stored: a
    // warp whose 8 pixels all lie there leaves its rows as they are
    if (cg * 8 < D && st.m0 + pw * P_PIX < me) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = 4 * h + (lane >> 3);
        const uint4 r = combine8(v[h], tb.w[px], tb.mk[px]);
        // row pw * 8 + px of the column tile, its 16 bytes cg in the
        // 128-byte swizzle: at 16 (cg ^ row % 8)
        const int row = pw * P_PIX + px;
        *reinterpret_cast<uint4*>(&sg.a[row * TK + (cg ^ (row & 7)) * 8]) = r;
      }
    }
    // the writes, seen by the wgmmas' (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.full[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // the next K tile's loads into nxt, then the store cursor's K tile (cur)
  // out; false after the last
  __device__ __forceinline__ bool step(const uint4 (&cur)[2][4], uint4 (&nxt)[2][4]) {
    if (ld.m0 < me) {
      const bool tap = ld.next(C);
      if (ld.m0 < me) {
        if (tap) corners(ld.taps & 1);
        load(nxt);
      }
    }
    store(cur);
    st.next(C);
    return st.m0 < me;
  }

  __device__ __forceinline__ void run(int mb) {
    if (mb >= me) return;
    ld = st = Cursor{mb, 0, 0, 0};
    fetch(mb, 0);
    corners(0);
    uint4 va[2][4], vb[2][4];
    load(va);
    while (step(va, vb) && step(vb, va)) {
    }
  }
};

// The consumer warpgroup: each tile's 64 pixels x 256 channels, one fp32
// sum over the whole K in the wgmma accumulators, rounded once to bf16 and
// stored through shared memory in 16-byte rows
__device__ __forceinline__ void consume(Smem& s, __nv_bfloat16* __restrict__ out, int n0, int mb,
                                        int me, int C, int Cout, int warp, int lane) {
  const int g = lane >> 2;   // accumulator row group
  const int tg = lane & 3;   // and column pair
  __nv_bfloat16(*ep)[EP_STRIDE] = s.ep[warp];
  float acc[128];  // the first wgmma of each tile ignores their values
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int m0 = mb; m0 < me; m0 += TM) {
    int kt = 0;
    for (int t = 0; t < TAPS; ++t) {
      for (int c0 = 0; c0 < C; c0 += TK, ++kt) {
        const int D = min(TK, C - c0);
        Stage& st = s.st[stage];
        mbar_wait(&s.full[stage], phase);
        __syncwarp();  // converged for the .aligned wgmma instructions
        const uint64_t da = sw128_desc(st.a);
        // B's core matrices: 128 bytes on along k, D * 16 along n
        const uint64_t db = smem_desc(st.b, 128, D * 16);
        wgmma_fence();
        // k16 step ks: A 32 bytes on in its swizzled rows, B two core
        // matrices (256 bytes) on (descriptor addresses count 16 bytes)
        wgmma_m64n256k16(acc, da, db, kt > 0);
        wgmma_m64n256k16(acc, da + 2, db + 16, 1);
        if (D == TK) {
          wgmma_m64n256k16(acc, da + 4, db + 32, 1);
          wgmma_m64n256k16(acc, da + 6, db + 48, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the last K tile's group has read its stage
        if (kt > 0 && threadIdx.x == 0) mbar_arrive(&s.empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    if (threadIdx.x == 0) mbar_arrive(&s.empty[prev]);
    // acc[4j .. 4j+3]: rows g and g+8 of the warp's 16, columns 8j + 2tg,
    // +1 of the 256; per 64 columns through the warp's staging rows
    const int r0 = m0 + warp * 16;
    const bool vec = Cout % 8 == 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = q * 8 + jj;
        *reinterpret_cast<__nv_bfloat162*>(&ep[g][8 * jj + 2 * tg]) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&ep[g + 8][8 * jj + 2 * tg]) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i * 4 + (lane >> 3);
        const int m = r0 + r;
        const int n = n0 + q * 64 + (lane & 7) * 8;
        if (m >= me || n >= Cout) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(&ep[r][(lane & 7) * 8]);
        __nv_bfloat16* o = out + (int64_t)m * Cout + n;
        if (vec && n + 8 <= Cout) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n + e < Cout)
              o[e] = __ushort_as_bfloat16((unsigned short)(u[e / 2] >> (16 * (e & 1))));
        }
      }
    }
  }
}

// Persistent: block (g, nb) owns pixels [g*M/G, (g+1)*M/G) and output
// channels nb*256 .. +255, in tiles of 64 pixels. Warps 0-3 multiply,
// warps 4-11 sample.
__global__ void __launch_bounds__(THREADS, 1)
dcn_conv_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,      // [B, H, W, C]
                         const float* __restrict__ off_y,          // [B, OH, OW, 9]
                         const float* __restrict__ off_x,          // [B, OH, OW, 9]
                         const float* __restrict__ mask,           // [B, OH, OW, 9]
                         const __nv_bfloat16* __restrict__ wprep,  // prepared weight
                         __nv_bfloat16* __restrict__ out,          // [B, OH, OW, Cout]
                         int B, int H, int W, int C, int OH, int OW, int Cout, int stride,
                         int G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles want 1024-byte boundaries (SMEM_BYTES leaves room);
  // offset from the shared array itself, so that the compiler keeps every
  // access in the shared space (LDS/STS, not generic loads and stores)
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int M = B * OH * OW;
  const int g = blockIdx.x % G;
  const int nb = blockIdx.x / G;
  const int mb = (int)((int64_t)g * M / G);
  const int me = (int)((int64_t)(g + 1) * M / G);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], P_WARPS + 1);
      mbar_init(&s.empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the two roles part here for the rest of the kernel (the warpgroup,
  // provably uniform across the warp)
  if (__shfl_sync(0xffffffffu, warp, 0) >= 4) {
    Producer{s, x, off_y, off_x, mask, wprep + (int64_t)nb * TAPS * C * TN, me, H, W, C, OH, OW,
             stride, warp - 4, lane, s.tab[warp - 4]}
        .run(mb);
  } else {
    consume(s, out, nb * TN, mb, me, C, Cout, warp, lane);
  }
}

}  // namespace bf16

}  // namespace

// wsplit: scratch of 2 * ceil(Cout / 256) * 256 * 9C floats (the prepared
// weight's big halves, then its small halves). The one check of the
// arguments: C a multiple of 32 and a stride of at least 1, else
// cudaErrorInvalidValue, which the wrapper raises.
extern "C" int dcn_conv_fwd(const void* x, const void* off_y, const void* off_x,
                            const void* mask, const void* weight, void* wsplit, void* out,
                            int B, int H, int W, int C, int OH, int OW,
                            int Cout, int stride, void* stream) {
  if (C % BK != 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if (B * OH * OW == 0 || Cout == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int K = TAPS * C;
  const int64_t total = (int64_t)((Cout + BN - 1) / BN) * BN * K;
  float* big = static_cast<float*>(wsplit);
  float* small = big + total;
  dcn_weight_prep_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(weight), big, small, K, Cout, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dcn_conv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  const int M = B * OH * OW;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  dcn_conv_fwd_kernel<<<grid, THREADS, sizeof(Smem), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask), big, small,
      static_cast<float*>(out), B, H, W, C, OH, OW, Cout, stride);
  return (int)cudaGetLastError();
}

// the grid of the last dcn_conv_fwd_bf16 launch (dcn_conv_fwd_bf16_grid)
static int bf16_last_grid[5];

// dcn_conv_fwd on a bf16 x, with a bf16 out; weight stays the fp32
// parameter [9C, Cout], which the prep kernel rounds to bf16 once into
// wprep: scratch of ceil(Cout / 256) * 256 * 9C bf16. The same check of
// the arguments, and x on an 8-byte boundary. One block an SM:
// ceil(Cout / 256) column blocks, each over G blocks of contiguous pixel
// ranges.
extern "C" int dcn_conv_fwd_bf16(const void* x, const void* off_y, const void* off_x,
                                 const void* mask, const void* weight, void* wprep, void* out,
                                 int B, int H, int W, int C, int OH, int OW,
                                 int Cout, int stride, void* stream) {
  if (C % BK != 0 || stride < 1 || (uintptr_t)x % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B * OH * OW == 0 || Cout == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (Cout + bf16::TN - 1) / bf16::TN;
  const int64_t total = (int64_t)nblk * bf16::TN * TAPS * C;
  __nv_bfloat16* prep = static_cast<__nv_bfloat16*>(wprep);
  bf16::weight_prep_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(weight), prep, C, Cout, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int M = B * OH * OW;
  // pixel ranges of at least one tile where M is small
  const int G = max(1, min(sms / nblk, (M + bf16::TM - 1) / bf16::TM));
  e = cudaFuncSetAttribute(bf16::dcn_conv_fwd_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bf16::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  bf16::dcn_conv_fwd_bf16_kernel<<<G * nblk, bf16::THREADS, bf16::SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask), prep,
      static_cast<__nv_bfloat16*>(out), B, H, W, C, OH, OW, Cout, stride, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the longest range (ceil(M / G) pixels) and its tiles, times the blocks
  // an SM takes in turn
  const int pixels = (M + G - 1) / G;
  const int tiles = (pixels + bf16::TM - 1) / bf16::TM * ((G * nblk + sms - 1) / sms);
  const int grid[5] = {sms, G * nblk, pixels, bf16::TM, tiles};
  for (int i = 0; i < 5; ++i) bf16_last_grid[i] = grid[i];
  return (int)cudaSuccess;
}

// the grid the last dcn_conv_fwd_bf16 launch used, into out[5]: the SMs,
// the blocks, the most pixels a block walks, the pixels a tile and the
// most tiles an SM walks (zeros before the first launch)
extern "C" int dcn_conv_fwd_bf16_grid(void* out) {
  for (int i = 0; i < 5; ++i) static_cast<int*>(out)[i] = bf16_last_grid[i];
  return (int)cudaSuccess;
}
