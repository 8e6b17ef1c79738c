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
// What the design does about it (from K7's first design, then further; the
// two phases are csrc/msda_fwd.cuh's build_payload and sum_payload, which
// K7 runs too):
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
// - bf16 (`msda_fwd_bf16`, the counterpart of _kernel_hi with
//   compute_dtype=bfloat16, computing the exact path's function on a bf16
//   value): the same body on a bf16 value, each lane's 4 channels by one
//   8-byte load widened to fp32 exactly, loc and attw fp32, the sums fp32,
//   the output rounded to bf16 once (nearest even, as the plain version's
//   cast). 8 lanes cover a 64-byte row of 32 channels, as in fp32. Its plan
//   is its own: every 8-lane group takes whole queries (SPLIT 1, here), and
//   the wrapper gives a block at least the 32 queries of one pass of its 8
//   warps (kernels/msda.py::k1_bf16_tile). At SCA's shape that took a call
//   from 0.95 ms (fp32's plan: 16 queries a block, SPLIT 4, whose
//   instantiation takes 78 registers, three blocks an SM) to 0.63 (SPLIT 1
//   at 64 registers, four blocks an SM, and no shuffles across groups);
//   fp32 K1 there takes 0.89 (tools/bench_msda_bf16.py on an H100 SXM).
//   Four lanes a row, each with one 16-byte load of 8 channels (half the
//   load instructions a sample), measured slower at every plan (0.80 ms
//   at SCA at best): a lane then holds 32 fp32 corner sums, and at the 64
//   registers that four blocks an SM allow ptxas spills them.
//
// `msda_fwd` runs the msda (kFull) and `msda_fwd_probe` the cost-split
// modes of csrc/msda_fwd.cuh on the same body (the counterpart of
// tools/bench_hi_probe.py's kernel variants), both on an fp32 value.

#include "msda_fwd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 227 * 1024;  // shared memory a block may use on sm_90
constexpr int kMaxTile = 128;           // kernels/msda.py::K1_TILES

template <int MODE, int SPLIT, typename T>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value,      // [B, K, H, D]
                const float* __restrict__ loc,    // [B, Q, H, L, P, 2]
                const float* __restrict__ attw,   // [B, Q, H, L, P]
                T* __restrict__ out,              // [B, Q, H, D]
                int K, int Q, int H, int D, int L, int P, int tile, int tiles,
                Levels lv) {
  extern __shared__ int4 payload[];
  int4* corners = payload;                                           // [tile * L * P]
  float4* weights = reinterpret_cast<float4*>(payload + tile * L * P);  // [tile * L * P]
  const int h = (int)(blockIdx.x % H);
  const int rest = (int)(blockIdx.x / H);
  const int q0 = (rest % tiles) * tile;
  const int b = rest / tiles;
  build_payload<MODE, kThreads>(corners, weights, loc, attw, b, h, q0, tile, Q, H, L, P, lv);
  __syncthreads();
  sum_payload<MODE, SPLIT, 1, kThreads>(corners, weights, value, out, b, h, q0, tile, K, Q, H,
                                        D, L, P);
}

template <int MODE, int SPLIT, typename T>
int launch_split(const T* value, const float* loc, const float* attw, T* out,
                 const Levels& lv, int K, int Q, int H, int D, int L, int P, int tile,
                 int tiles, unsigned blocks, size_t smem, cudaStream_t stream) {
  auto kernel = msda_fwd_kernel<MODE, SPLIT, T>;
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
// multiple of 32, and value and out on 16-byte boundaries (as the fp32
// float4 loads and stores need; bf16 is held to the same); anything else
// returns cudaErrorInvalidValue, which the wrapper raises. `split`: 8-lane
// groups a query, 1, 2 or 4.
template <int MODE, typename T>
int launch_msda_fwd(const void* value, const void* loc, const void* attw, void* out,
                    const void* level_hw, int L, int B, int K, int Q, int H, int D,
                    int P, int tile, int split, void* stream) {
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
  const T* v = static_cast<const T*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  T* o = static_cast<T*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned n = (unsigned)blocks;
  switch (split) {
    case 1: return launch_split<MODE, 1, T>(v, lo, a, o, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
    case 2: return launch_split<MODE, 2, T>(v, lo, a, o, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
    default: return launch_split<MODE, 4, T>(v, lo, a, o, lv, K, Q, H, D, L, P, tile, tiles, n, smem, s);
  }
}

}  // namespace

// tile: queries per block (the wrapper's kernels/msda.py::k1_tile)
extern "C" int msda_fwd(const void* value, const void* loc, const void* attw,
                        void* out, const void* level_hw, int L, int B, int K,
                        int Q, int H, int D, int P, int tile, void* stream) {
  return launch_msda_fwd<kFull, float>(value, loc, attw, out, level_hw, L, B, K, Q, H, D, P,
                                       tile, split_for(L * P), stream);
}

// msda_fwd on a bf16 value, with a bf16 out (loc and attw fp32), whole
// queries a group (tile: the wrapper's kernels/msda.py::k1_bf16_tile)
extern "C" int msda_fwd_bf16(const void* value, const void* loc, const void* attw,
                             void* out, const void* level_hw, int L, int B, int K,
                             int Q, int H, int D, int P, int tile, void* stream) {
  return launch_msda_fwd<kFull, __nv_bfloat16>(value, loc, attw, out, level_hw, L, B, K, Q, H,
                                               D, P, tile, 1, stream);
}

extern "C" int msda_fwd_probe(const void* value, const void* loc, const void* attw,
                              void* out, const void* level_hw, int L, int B, int K,
                              int Q, int H, int D, int P, int mode, int tile,
                              void* stream) {
  switch (mode) {
    case kGather:
      return launch_msda_fwd<kGather, float>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                      P, tile, split_for(L * P), stream);
    case kWeights:
      return launch_msda_fwd<kWeights, float>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                       P, tile, split_for(L * P), stream);
    case kNoop:
      return launch_msda_fwd<kNoop, float>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                    P, tile, split_for(L * P), stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
