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
// smp_ref, a bf16 product with fp32 sums, the output rounded to bf16). One
// bf16 product per multiply-add, m64n64k16 (.f32.bf16.bf16), where fp32
// needs three TF32 ones: a stage-3 call's 41 GFLOP are 42 us at the card's
// 989 TFLOP/s dense bf16. The column is the plain version's bitwise
// (kernels/dcn.py::dcn_conv_plain): each corner times its bilinear weight,
// summed in the order (0,0), (0,1), (1,0), (1,1), times the mask, with no
// FMA, rounded once to bf16 as it is written to shared memory. A prep
// kernel rounds the fp32 weight [9C, Cout] once to bf16 into the same tile
// order as the fp32 path's (core matrices of 8 columns x 8 k, 16 bytes of k
// a row, K-major, so the descriptor's transpose bit stays 0; 512 bytes to
// the n-neighbour, 128 to the k-neighbour). The K tile stays 32 deep (two
// k16 steps), summed into fresh accumulators and added to the fp32 ones by
// round-to-nearest adds, as above. Sampling maps a thread to one pixel and 4
// channels of the column tile (64 pixels x 8 groups = the 512 threads): 4
// corner loads of 8 bytes each a tile, where lane = channel took 16 of 2
// bytes (measured on an H100 80GB HBM3 at 700 W, stage 3: 0.717 ms a call
// with lane = channel, 0.395 with this mapping). Still a simple kernel,
// sampling in lockstep with its wgmmas: one block of 512 threads (96
// registers) an SM, 62 KB of shared memory; the output is stored element by
// element.
// The JAX kernel also rounds its bilinear x-weights to bf16 (it samples by
// a one-hot matmul); here they stay fp32, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// shared-memory matrix descriptor, no swizzle: K-major core matrices of 8
// rows x 16 bytes, k_bytes apart along k and n_bytes along n
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t k_bytes = CORE_K_BYTES,
                                              uint32_t n_bytes = CORE_N_BYTES) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(k_bytes >> 4) << 16) |
         ((uint64_t)(n_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
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
      wgmma_64x64x8(part, a_small[ks], smem_desc(bbig + ks * 2 * CORE), ks > 0);
      wgmma_64x64x8(part, a_big[ks], smem_desc(bsmall + ks * 2 * CORE), 1);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
      wgmma_64x64x8(part, a_big[ks], smem_desc(bbig + ks * 2 * CORE), 1);
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

constexpr int A16_STRIDE = BK + 8;  // bf16: 32-bit A-fragment loads hit 32 banks per warp
constexpr int CORE16 = 64;          // bf16 of one 8 x 8 core matrix
constexpr uint32_t CORE16_N_BYTES = (BK / 8) * 128;  // descriptor: to the next core matrix along n

struct Smem16 {
  __nv_bfloat16 b[2][B_TILE];           // weight tiles, core-matrix order (first: 128-byte aligned)
  __nv_bfloat16 a[2][BM][A16_STRIDE];   // sampled column tiles [pixel][k]
  int idx[TAPS][4][BM];                 // corner element offset into x, -1 if outside
  float w[TAPS][4][BM];                 // bilinear weight of each corner
  float mask[TAPS][BM];
};

// d [64 x 64] = a [64 x 16] (registers) * b [16 x 64] (descriptor, K-major)
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_64x64x16_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// weight [K, Cout] fp32 -> bf16 (nearest even), per (256-column block nb,
// K tile kt) one B_TILE chunk at (nb * K/BK + kt) * B_TILE, core matrix
// (ng, kg) at (ng * 4 + kg) * CORE16, element (column r, k q) of it at
// r * 8 + q; zeros past Cout
__global__ void dcn_weight_prep_bf16_kernel(const float* __restrict__ weight,
                                            __nv_bfloat16* __restrict__ prep, int K, int Cout,
                                            int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int q = (int)(i & 7);
  const int r = (int)((i >> 3) & 7);
  const int kg = (int)((i >> 6) & 3);
  const int ng = (int)((i >> 8) & 31);
  const int64_t tile = i >> 13;  // nb * (K / BK) + kt
  const int kt = (int)(tile % (K / BK));
  const int nb = (int)(tile / (K / BK));
  const int n = nb * BN + ng * 8 + r;
  const int k = kt * BK + kg * 8 + q;
  prep[i] = __float2bfloat16_rn(n < Cout ? weight[(int64_t)k * Cout + n] : 0.f);
}

// this thread's corners of one column tile: pixel mi, 4 channels from
// channel c of tap t (one 8-byte load a corner)
__device__ __forceinline__ void load_corners16(uint2 (&v)[4], const Smem16& s,
                                               const __nv_bfloat16* __restrict__ x, int t, int c,
                                               int mi) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = s.idx[t][j][mi];
    v[j] = id >= 0 ? __ldg(reinterpret_cast<const uint2*>(x + id + c)) : make_uint2(0u, 0u);
  }
}

// the 4 column values in the plain version's arithmetic, each rounded once,
// into the tile at (mi, cq .. cq+3)
__device__ __forceinline__ void store_column16(__nv_bfloat16 (*as)[A16_STRIDE],
                                               const uint2 (&v)[4], const Smem16& s, int t,
                                               int mi, int cq) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s.idx[t][j][mi] < 0) continue;
    const float w = s.w[t][j][mi];
    // a bf16 is the top half of the fp32 of the same value
    const float f[4] = {__uint_as_float(v[j].x << 16), __uint_as_float(v[j].x & 0xffff0000u),
                        __uint_as_float(v[j].y << 16), __uint_as_float(v[j].y & 0xffff0000u)};
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = __fadd_rn(a[e], __fmul_rn(f[e], w));
  }
  const float mk = s.mask[t][mi];
  const __nv_bfloat162 lo = __floats2bfloat162_rn(__fmul_rn(a[0], mk), __fmul_rn(a[1], mk));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(__fmul_rn(a[2], mk), __fmul_rn(a[3], mk));
  *reinterpret_cast<uint2*>(&as[mi][cq]) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

__global__ void __launch_bounds__(THREADS, 1)
dcn_conv_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,  // [B, H, W, C]
                         const float* __restrict__ off_y,      // [B, OH, OW, 9]
                         const float* __restrict__ off_x,      // [B, OH, OW, 9]
                         const float* __restrict__ mask,       // [B, OH, OW, 9]
                         const __nv_bfloat16* __restrict__ wprep,  // prepared weight
                         __nv_bfloat16* __restrict__ out,      // [B, OH, OW, Cout]
                         int B, int H, int W, int C, int OH, int OW, int Cout, int stride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem16& s = *reinterpret_cast<Smem16*>(smem_raw);

  const int M = B * OH * OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KT = TAPS * C / BK;
  const __nv_bfloat16* gw = wprep + (int64_t)blockIdx.y * KT * B_TILE;
  auto load_weight_tile = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < B_TILE / 8 / THREADS; ++i) {
      const int e = (tid + i * THREADS) * 8;
      cp_async16(&s.b[buf][e], gw + (int64_t)kt * B_TILE + e);
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
    float mk = 0.f;
    if (m < M) {
      const int b = m / (OH * OW);
      const int r = m % (OH * OW);
      const int oy = r / OW;
      const int ox = r % OW;
      const int64_t o = (int64_t)m * TAPS + t;
      const float py = (float)(oy * stride - 1 + t / 3) + off_y[o];
      const float px = (float)(ox * stride - 1 + t % 3) + off_x[o];
      mk = mask[o];
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
            idx[j] = ((b * H + yy) * W + xx) * C;
            wt[j] = cw[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.idx[t][j][mi] = idx[j];
      s.w[t][j][mi] = wt[j];
    }
    s.mask[t][mi] = mk;
  }
  __syncthreads();

  // sampling: thread tid takes pixel tid / 8 and channels 4 (tid % 8) .. +3
  // of each column tile
  const int smi = tid >> 3;
  const int scq = (tid & 7) * 4;
  uint2 v[4];
  load_corners16(v, s, x, 0, scq, smi);
  store_column16(s.a[0], v, s, 0, smi, scq);

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
    // as in dcn_conv_fwd_kernel: tile kt landed and written, tile kt-1 done
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const bool more = kt + 1 < KT;
    const int k1 = (kt + 1) * BK;
    const int t1 = k1 / C;
    if (more) {
      load_weight_tile(kt + 1, cur ^ 1);
      load_corners16(v, s, x, t1, k1 % C + scq, smi);
    }
    cp_async_commit();

    const __nv_bfloat16(*as)[A16_STRIDE] = s.a[cur];
    // this warpgroup's 64 columns: 8 core-matrix rows of CORE16_N_BYTES each
    const __nv_bfloat16* bt = &s.b[cur][wg * (WG_N / 8) * (BK / 8) * CORE16];
    // A fragments (mma.m16n8k16's layout): rows r, r+8; k 2tg, 2tg+1 and
    // 2tg+8, 2tg+9 of each k16 step, two bf16 a register, the lower k low
    const int r = wr * 16 + g;
    uint32_t af[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int c = ks * 16 + 2 * tg;
      af[ks][0] = *reinterpret_cast<const uint32_t*>(&as[r][c]);
      af[ks][1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][c]);
      af[ks][2] = *reinterpret_cast<const uint32_t*>(&as[r][c + 8]);
      af[ks][3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][c + 8]);
      wgmma_fence();
      // k16 step ks reads core matrices 2*ks, 2*ks+1 along k
      wgmma_64x64x16_bf16(part, af[ks], smem_desc(bt + ks * 2 * CORE16, 128, CORE16_N_BYTES),
                          ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    if (more) store_column16(s.a[cur ^ 1], v, s, t1, smi, scq);
  }

  // acc[4j .. 4j+3]: rows g and g+8 of the warp's 16, columns 8j + 2tg, +1
  // of the warpgroup's 64; each rounded to bf16 once
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wr * 16 + g + half * 8;
    if (m >= M) continue;
    __nv_bfloat16* orow = out + (int64_t)m * Cout;
#pragma unroll
    for (int j = 0; j < WG_N / 8; ++j) {
      const int n = n0 + wg * WG_N + 8 * j + 2 * tg;
      if (n < Cout) orow[n] = __float2bfloat16_rn(acc[4 * j + 2 * half]);
      if (n + 1 < Cout) orow[n + 1] = __float2bfloat16_rn(acc[4 * j + 2 * half + 1]);
    }
  }
}

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

// dcn_conv_fwd on a bf16 x, with a bf16 out; weight stays the fp32
// parameter [9C, Cout], which the prep kernel rounds to bf16 once into
// wprep: scratch of ceil(Cout / 256) * 256 * 9C bf16. The same check of
// the arguments, and x on an 8-byte boundary.
extern "C" int dcn_conv_fwd_bf16(const void* x, const void* off_y, const void* off_x,
                                 const void* mask, const void* weight, void* wprep, void* out,
                                 int B, int H, int W, int C, int OH, int OW,
                                 int Cout, int stride, void* stream) {
  if (C % BK != 0 || stride < 1 || (uintptr_t)x % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B * OH * OW == 0 || Cout == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int K = TAPS * C;
  const int64_t total = (int64_t)((Cout + BN - 1) / BN) * BN * K;
  __nv_bfloat16* prep = static_cast<__nv_bfloat16*>(wprep);
  dcn_weight_prep_bf16_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(weight), prep, K, Cout, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dcn_conv_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem16));
  if (e != cudaSuccess) return (int)e;
  const int M = B * OH * OW;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  dcn_conv_fwd_bf16_kernel<<<grid, THREADS, sizeof(Smem16), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(off_y),
      static_cast<const float*>(off_x), static_cast<const float*>(mask), prep,
      static_cast<__nv_bfloat16*>(out), B, H, W, C, OH, OW, Cout, stride);
  return (int)cudaGetLastError();
}
