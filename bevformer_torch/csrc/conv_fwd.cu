// Dense 2-D convolution forward (any kernel size, stride and zero padding)
// as an implicit GEMM on the tensor cores, with the per-channel affine, the
// residual add and the ReLU in its epilogue, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package leaves its backbone and neck
// convolutions to XLA (bevformer_tpu/models/resnet.py, fpn.py); the port
// ran them in cuDNN fp32 with TF32 off, then FrozenBN's multiply and add,
// the residual add and the ReLU as passes of their own. This kernel
// computes, for output pixel m and channel n,
//   out[m, n] = act(sum_k A[m, k] W[k, n] * scale[n] + shift[n] (+ res[m, n]))
// with A the implicit im2col of a channels-last x [B, H, W, Cin] (k = (ky *
// KW + kx) * Cin + c, zeros outside the image), W nn.Conv2d's weight
// [Cout, Cin, KH, KW], act the identity or the ReLU, and res, where given,
// [B, OH, OW, Cout] like out.
//
// What bounds it on this card: the contraction for the 3x3 convs and the
// 1x1 convs from 256 channels up (a bevformer_base stage-2 3x3 conv is 41
// GFLOP against 0.14 GB), the bytes for stage 1's 1x1 convs (at 6 x 232 x
// 400 pixels a 64 -> 256 conv with its residual moves 1.3 GB for 18
// GFLOP). The port computes in fp32, so the products run as 3xTF32, as K2
// (csrc/dcn_conv_fwd.cu) does: each operand split into big = rna(a) and
// small = rna(a - big) (cvt.rna.tf32.f32, never the tensor core's
// truncation of raw fp32 bits), small*big' + big*small' + big*big' on the
// tensor cores: 165 TFLOP/s of the card's 495 TF32, against the 67 of the
// fp32 SIMT units that cuDNN's fp32 algorithms use. The tensor cores round
// each accumulation toward zero (one accumulator over K = 9*512 drifts
// ~4e-5 of scale; tests/test_torch_conv_tf32.py emulates it), so each
// 32-deep K tile is summed into fresh MMA accumulators, which are then added
// into fp32 accumulators that round to nearest.
//
// What the design does about it:
// - Persistent and warp-specialised: one block of 384 threads an SM. Warps
//   0-7 (two warpgroups) multiply; a tile is 128 output pixels x BN output
//   channels (BN 128 or 64, the wrapper's choice by Cout and the number of
//   tiles), 64 pixels a warpgroup. Warps 8-11 load. They meet in a ring of
//   4 stages in shared memory, each with a full and an empty mbarrier;
//   nothing in the main loop waits on __syncthreads.
// - Each 32-deep K tile lies in one tap (Cin a multiple of 32), so its A
//   tile is 128 rows of 128 contiguous bytes of x. Each loading warp copies
//   32 of them by 16-byte cp.async, 8 lanes a row, zero-filled where the
//   tap falls outside the image or the pixel past M (each pixel's origin in
//   x is tabled once a tile), and their completion arrives on the stage's
//   full barrier (cp.async.mbarrier.arrive.noinc). One lane brings the
//   weight tile, its big and small halves, by one cp.async.bulk onto the
//   same barrier. One loading warp left the tensor cores idle most of the
//   time (a 128 -> 128 3x3 conv at 116 x 200 took 0.855 ms against 0.445
//   with four).
// - The weight is prepared once per parameter (conv_weight_prep; the
//   wrapper caches it): split into its TF32 halves, per BN-column block and
//   K tile in the K-major core matrices that wgmma's descriptor reads (8
//   columns x 4 k each, the k-neighbour 128 bytes on, the n-neighbour 1024).
// - A comes from registers (m64nBNk8 .tf32): each thread reads its fragment
//   of the raw tile and splits it. The tile's rows are padded to 40 floats,
//   and within each 8-deep step the k order is permuted (logical k q and q +
//   4 are channels 2q and 2q + 1; the prep permutes the weight alike), so a
//   thread's two values of a row are one conflict-free 8-byte load.
// - A K tile's 12 wgmmas (its small cross products first, then its big
//   ones, as K2) go out as one group; each warp releases the stage once
//   they have retired, then adds them into its fp32 sums. The two
//   warpgroups need not run in step, so one's adds and loads can overlap
//   the other's products.
// - The epilogue applies scale, shift, residual and ReLU to the fp32 sums
//   and stores 16-byte rows of the channels-last output (lane pairs trade
//   halves by shuffles), while the loading warps fill the next tile's
//   stages. Tiles are walked n-block fastest, so blocks running together
//   read the same input rows from the L2.
// Measured (tools/bench_conv.py, NVIDIA H100 80GB HBM3, 700.00 W): a base
// frame's 84 convs in 33.8 ms (56 TFLOP/s, 39% of their bound) against
// 153.0 for cuDNN fp32 with the elementwise passes. At the 128 -> 128 3x3
// conv the copies alone (no products) take 0.26 of its 0.45 ms and the
// products alone (no copies of A) 0.36: each K tile and block brings 48
// KB from the L2, 32 of them the split weight. Timed as edits of this
// source and not kept: 2- and 4-block clusters multicasting the weight
// tile (slower: the blocks wait on each other), the two warpgroups taking
// the tensor cores in turns, A from shared memory by descriptor (neither
// moved it), an L2 prefetch of the residual (slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {
namespace conv {

constexpr int BM = 128;                     // output pixels a tile
constexpr int BK = 32;                      // K tile: 32 channels of one tap
constexpr int STAGES = 4;                   // ring depth
constexpr int MMA_WARPS = 8;                // two warpgroups, then the loading warps
constexpr int LOAD_WARPS = 4;
constexpr int THREADS = 32 * (MMA_WARPS + LOAD_WARPS);
constexpr int LOAD_ROWS = BM / LOAD_WARPS;  // the tile rows each loading warp copies
constexpr int A_STRIDE = BK + 8;            // floats a row of the A tile
constexpr int CORE = 32;                    // floats of one 8 x 4 core matrix
constexpr uint32_t CORE_K_BYTES = 128;      // descriptor: to the next core matrix along k
constexpr uint32_t CORE_N_BYTES = 1024;     // descriptor: to the next core matrix along n

template <int BN>
struct alignas(128) Stage {
  float b[2][BN * BK];     // the weight tile: TF32 big halves, then small, core-matrix order
  float a[BM * A_STRIDE];  // the input tile [pixel][channel], fp32 as in x
};

template <int BN>
struct Smem {
  Stage<BN> st[STAGES];
  int4 rows[BM];  // the loader's table: each pixel's {offset of (b, iy0, ix0) in x, iy0, ix0, 0}
  uint64_t full[STAGES];   // the loading warps' lanes' copies, and the weight tile's bytes
  uint64_t empty[STAGES];  // the 8 multiplying warps
};

struct Args {
  const float* x;      // [B, H, W, Cin]
  const float* wprep;  // the prepared weight
  const float* scale;  // [Cout]
  const float* shift;  // [Cout]
  const float* res;    // [B, OH, OW, Cout] or null
  float* out;          // [B, OH, OW, Cout]
  int B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad, relu;
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

// 16 bytes global -> shared, or 16 zero bytes where bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// one arrival on bar once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t core_desc(const void* p) {
  return smem_desc(p, CORE_K_BYTES, CORE_N_BYTES);
}

// d [64 x 64] = a [64 x 8] (registers) * b [8 x 64] (descriptor) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d [64 x 128] = a [64 x 8] (registers) * b [8 x 128] (descriptor) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


// weight [Cout, Cin, KH, KW] -> per (BN-column block nb, K tile kt) one
// chunk of 2 * BN * BK floats at (nb * KT + kt) * 2 * BN * BK: the big
// halves, then the small; core matrix (ng, kg) at (ng * 8 + kg) * CORE,
// element (column r, k q) of it at r * 4 + q, which holds channel
// kt * BK + (kg / 2) * 8 + 2q + kg % 2 of tap (kt * BK) / Cin
__global__ void conv_weight_prep_kernel(const float* __restrict__ w, float* __restrict__ prep,
                                        int Cin, int KH, int KW, int BN, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int T = BN * BK;
  const int64_t chunk = i / (2 * T);
  const int within = (int)(i % (2 * T));
  const int e = within % T;
  const int KT = KH * KW * Cin / BK;
  const int nb = (int)(chunk / KT);
  const int kt = (int)(chunk % KT);
  const int core = e / CORE;
  const int ng = core / 8, kg = core % 8;
  const int r = (e % CORE) / 4, q = e % 4;
  const int n = nb * BN + ng * 8 + r;
  const int k = kt * BK + (kg >> 1) * 8 + 2 * q + (kg & 1);
  const int tap = k / Cin, c = k % Cin;
  uint32_t big, small;
  split(w[(((int64_t)n * Cin + c) * KH + tap / KW) * KW + tap % KW], big, small);
  prep[i] = __uint_as_float(within < T ? big : small);
}

// loading warp lw: for each of this block's tiles, rows lw * LOAD_ROWS ..
// of its K tiles into the ring (and warp 0 the weight tiles)
template <int BN>
__device__ __forceinline__ void load(Smem<BN>& s, const Args& p, int M, int NB, int tiles,
                                     int KT, int lw, int lane) {
  constexpr uint32_t B_BYTES = 2 * BN * BK * sizeof(float);
  const int chunk = lane & 7;  // the 16-byte chunk of a row
  const int sub = lane >> 3;   // the row of each 4
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / NB * BM;
    const float* wtile = p.wprep + (int64_t)(t % NB) * KT * 2 * BN * BK;
    __syncwarp();  // every lane is done with the last tile's table
    for (int r = lw * LOAD_ROWS + lane; r < (lw + 1) * LOAD_ROWS; r += 32) {
      const int m = m0 + r;
      int4 e = make_int4(0, -(1 << 28), 0, 0);  // past M: every tap outside
      if (m < M) {
        const int b = m / (p.OH * p.OW);
        const int rem = m % (p.OH * p.OW);
        const int iy0 = rem / p.OW * p.stride - p.pad;
        const int ix0 = rem % p.OW * p.stride - p.pad;
        e = make_int4(((b * p.H + iy0) * p.W + ix0) * p.Cin, iy0, ix0, 0);
      }
      s.rows[r] = e;
    }
    __syncwarp();
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int stage = it % STAGES;
      mbar_wait(&s.empty[stage], ((it / STAGES) & 1) ^ 1);
      Stage<BN>& sg = s.st[stage];
      if (lw == 0 && lane == 0) {
        mbar_arrive_expect_tx(&s.full[stage], B_BYTES);
        bulk_copy(sg.b, wtile + (int64_t)kt * 2 * BN * BK, B_BYTES, &s.full[stage]);
      }
      const int k0 = kt * BK;
      const int tap = k0 / p.Cin;
      const int ky = tap / p.KW, kx = tap % p.KW;
      const int koff = (ky * p.W + kx) * p.Cin + k0 % p.Cin + chunk * 4;
      const int row0 = lw * LOAD_ROWS + sub;
      const uint32_t dst = smem_u32(sg.a) + (row0 * A_STRIDE + chunk * 4) * 4;
#pragma unroll 8
      for (int i = 0; i < LOAD_ROWS / 4; ++i) {
        const int4 e = s.rows[row0 + 4 * i];
        const bool in =
            (unsigned)(e.y + ky) < (unsigned)p.H && (unsigned)(e.z + kx) < (unsigned)p.W;
        cp_async16(dst + i * 4 * A_STRIDE * 4, in ? p.x + (e.x + koff) : p.x, in ? 16 : 0);
      }
      cp_async_arrive(&s.full[stage]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the multiplying warps: warpgroup wg takes pixels wg * 64 .. of each tile,
// warp wr of it 16 of them
template <int BN>
__device__ __forceinline__ void mma(Smem<BN>& s, const Args& p, int M, int NB, int tiles,
                                    int KT, int warp, int lane) {
  constexpr int NACC = BN / 2;
  const int wg = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  // this thread's fragment: rows g and g + 8 of its warp's 16, channels
  // 2tg and 2tg + 1 of each 8 (logical k tg and tg + 4)
  const int arow = (wg * 64 + wr * 16 + g) * A_STRIDE + 2 * tg;
  float acc[NACC];   // fp32 sums over the K tiles done
  float part[NACC];  // the wgmmas' sum over this K tile
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / NB * BM;
    const int n0 = t % NB * BN;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int stage = it % STAGES;
      mbar_wait(&s.full[stage], (it / STAGES) & 1);
      const Stage<BN>& sg = s.st[stage];
      uint32_t a_big[BK / 8][4], a_small[BK / 8][4];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        const float2 lo = *reinterpret_cast<const float2*>(&sg.a[arow + ks * 8]);
        const float2 hi = *reinterpret_cast<const float2*>(&sg.a[arow + 8 * A_STRIDE + ks * 8]);
        const float v[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(v[i], a_big[ks][i], a_small[ks][i]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        wgmma_tf32(part, a_small[ks], core_desc(sg.b[0] + ks * 2 * CORE), ks > 0);
        wgmma_tf32(part, a_big[ks], core_desc(sg.b[1] + ks * 2 * CORE), 1);
      }
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks)
        wgmma_tf32(part, a_big[ks], core_desc(sg.b[0] + ks * 2 * CORE), 1);
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      // round-to-nearest fp32 adds: the wgmmas' own accumulation truncates
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += part[i];
    }
    // acc[4j .. 4j+3]: rows g, g (columns 8j + 2tg, +1), then g + 8; lane
    // pairs trade so that an even lane holds row g, columns 8j + 4(tg/2)
    // .. +3, and an odd lane row g + 8 of the same columns
    const int odd = tg & 1;
    const int m = m0 + wg * 64 + wr * 16 + g + 8 * odd;
    const int col = n0 + 4 * (tg >> 1);
    float* orow = p.out + (int64_t)m * p.Cout;
    const float* rrow = p.res ? p.res + (int64_t)m * p.Cout : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
      float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                     : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
      const int n = col + 8 * j;
      const float4 sc = __ldg(reinterpret_cast<const float4*>(p.scale + n));
      const float4 sh = __ldg(reinterpret_cast<const float4*>(p.shift + n));
      v.x = fmaf(v.x, sc.x, sh.x);
      v.y = fmaf(v.y, sc.y, sh.y);
      v.z = fmaf(v.z, sc.z, sh.z);
      v.w = fmaf(v.w, sc.w, sh.w);
      if (m < M) {
        if (rrow) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(rrow + n));
          v.x += r.x;
          v.y += r.y;
          v.z += r.z;
          v.w += r.w;
        }
        if (p.relu) {
          v.x = fmaxf(v.x, 0.f);
          v.y = fmaxf(v.y, 0.f);
          v.z = fmaxf(v.z, 0.f);
          v.w = fmaxf(v.w, 0.f);
        }
        *reinterpret_cast<float4*>(orow + n) = v;
      }
    }
  }
}

// Persistent: block b takes tiles b, b + G, ..., tile t = (pixel block
// t / NB, column block t % NB)
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) conv_fwd_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<BN>& s = *reinterpret_cast<Smem<BN>*>(smem_raw);
  const int M = p.B * p.OH * p.OW;
  const int NB = p.Cout / BN;
  const int tiles = (M + BM - 1) / BM * NB;
  const int KT = p.KH * p.KW * p.Cin / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 32 * LOAD_WARPS + 1);
      mbar_init(&s.empty[i], MMA_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the roles part here for the rest of the kernel (the warp index,
  // provably uniform across the warp)
  if (__shfl_sync(0xffffffffu, warp, 0) >= MMA_WARPS) {
    load<BN>(s, p, M, NB, tiles, KT, warp - MMA_WARPS, lane);
  } else {
    mma<BN>(s, p, M, NB, tiles, KT, warp, lane);
  }
}

template <int BN>
int launch(const Args& p, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int smem = (int)sizeof(Smem<BN>);
  e = cudaFuncSetAttribute(conv_fwd_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (p.B * p.OH * p.OW + BM - 1) / BM * (p.Cout / BN);
  conv_fwd_kernel<BN><<<tiles < sms ? tiles : sms, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace conv
}  // namespace

// prep: scratch of 2 * Cout * KH * KW * Cin floats, the weight [Cout, Cin,
// KH, KW] in conv_fwd's tile order for column blocks of bn (64 or 128)
extern "C" int conv_weight_prep(const void* weight, void* prep, int Cout, int Cin, int KH, int KW,
                                int bn, void* stream) {
  if (Cin % conv::BK != 0 || (bn != 64 && bn != 128) || Cout % bn != 0 || KH < 1 || KW < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)2 * Cout * KH * KW * Cin;
  if (total == 0) return (int)cudaSuccess;
  conv::conv_weight_prep_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                  (cudaStream_t)stream>>>(static_cast<const float*>(weight),
                                                          static_cast<float*>(prep), Cin, KH, KW,
                                                          bn, total);
  return (int)cudaGetLastError();
}

// out = act(conv(x, weight) * scale + shift (+ res)), channels-last; wprep
// from conv_weight_prep at the same bn; res may be null; relu 0 or 1. The
// one check of the arguments: Cin a multiple of 32, Cout of bn (64 or
// 128), the output size that of the stride and padding, every pointer on a
// 16-byte boundary, else cudaErrorInvalidValue, which the wrapper raises.
extern "C" int conv_fwd(const void* x, const void* wprep, const void* scale, const void* shift,
                        const void* res, void* out, int B, int H, int W, int Cin, int OH, int OW,
                        int Cout, int KH, int KW, int stride, int pad, int relu, int bn,
                        void* stream) {
  const void* ptrs[6] = {x, wprep, scale, shift, res, out};
  for (const void* q : ptrs)
    if ((uintptr_t)q % 16 != 0) return (int)cudaErrorInvalidValue;
  if (Cin % conv::BK != 0 || (bn != 64 && bn != 128) || Cout % bn != 0 || stride < 1 || pad < 0 ||
      KH < 1 || KW < 1 || OH != (H + 2 * pad - KH) / stride + 1 ||
      OW != (W + 2 * pad - KW) / stride + 1)
    return (int)cudaErrorInvalidValue;
  if (B * OH * OW == 0 || Cout == 0) return (int)cudaSuccess;
  const conv::Args p{static_cast<const float*>(x), static_cast<const float*>(wprep),
                     static_cast<const float*>(scale), static_cast<const float*>(shift),
                     static_cast<const float*>(res), static_cast<float*>(out),
                     B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad, relu};
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 128 ? conv::launch<128>(p, st) : conv::launch<64>(p, st);
}
