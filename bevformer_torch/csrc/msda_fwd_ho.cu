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
// value, loc, attw and out at the card's memory rate. The first K7 read
// them lane = channel, one 4-byte load per lane and corner: its gather
// probe alone took 1.916 of its 1.988 ms at the SCA bench shape.
//
// What the design does about it: one block per (b*h, tile of QB
// consecutive queries), heads outer (grid y = b*H + h), on K1's two phases
// (csrc/msda_fwd.cuh). Phase 1 builds the tile's payload in shared memory:
// for each (query, level, point) the four corner pixels (-1 outside) and the
// four weights bilinear * attw, once per sample. Phase 2 reads corner rows
// with 16-byte loads, 8 lanes per 128-byte row; the warp's four 8-lane
// groups take SPLIT-way shares of one query's samples (SPLIT by the samples
// per query, as K1: 4 at SCA's 32), each share into ACC independent sets of
// corner accumulators (ACC samples in flight), summed in the plain version's
// order and across the groups by __shfl_xor. The TPU kernel drops an item
// whose rows miss its window; this one reads every corner wherever it lies,
// so no mass is dropped and there is nothing to audit.
//
// The C entry dispatches to a fixed set of (mode, QB, ACC): kFull at every
// (QB, ACC) of the sweep of tools/bench_kernel_probe3.py, the cost-split
// modes of csrc/msda_fwd.cuh (tools/bench_kernel_probe.py) at the default
// tile. QB is a launch argument, ACC and SPLIT template parameters.

#include "msda_fwd.cuh"

namespace {

constexpr int kHoThreads = 256;
constexpr int kHoTile = 16;  // kernels/msda.py::HO_TILE
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use on sm_90

template <int MODE, int SPLIT, int ACC>
__global__ void __launch_bounds__(kHoThreads)
msda_fwd_ho_kernel(const float* __restrict__ value,  // [B, K, H, D]
                   const float* __restrict__ loc,    // [B, Q, H, L, P, 2]
                   const float* __restrict__ attw,   // [B, Q, H, L, P]
                   float* __restrict__ out,          // [B, Q, H, D]
                   int K, int Q, int H, int D, int L, int P, int tile, Levels lv) {
  extern __shared__ int4 smem[];
  int4* corners = smem;                                           // [tile * L * P]
  float4* weights = reinterpret_cast<float4*>(smem + tile * L * P);  // [tile * L * P]
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * tile;
  build_payload<MODE, kHoThreads>(corners, weights, loc, attw, b, h, q0, tile, Q, H, L, P, lv);
  __syncthreads();
  sum_payload<MODE, SPLIT, ACC, kHoThreads>(corners, weights, value, out, b, h, q0, tile, K, Q,
                                            H, D, L, P);
}

template <int MODE, int SPLIT, int ACC>
int launch_ho(const float* value, const float* loc, const float* attw, float* out,
              const Levels& lv, int B, int K, int Q, int H, int D, int L, int P, int tile,
              size_t smem, cudaStream_t stream) {
  auto kernel = msda_fwd_ho_kernel<MODE, SPLIT, ACC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((Q + tile - 1) / tile), (unsigned)(B * H));
  kernel<<<grid, kHoThreads, smem, stream>>>(value, loc, attw, out, K, Q, H, D, L, P, tile, lv);
  return (int)cudaGetLastError();
}

template <int MODE, int ACC>
int launch_acc(const float* v, const float* lo, const float* a, float* o, const Levels& lv,
               int B, int K, int Q, int H, int D, int L, int P, int tile, size_t smem,
               cudaStream_t s) {
  switch (split_for(L * P)) {
    case 1: return launch_ho<MODE, 1, ACC>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
    case 2: return launch_ho<MODE, 2, ACC>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
    default: return launch_ho<MODE, 4, ACC>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
  }
}

}  // namespace

// mode: MsdaMode; tile: queries per block (8, 16, 32, 64 for kFull,
// kHoTile otherwise); acc: independent accumulator sets per 8-lane group
// (1, 2 for kFull, 1 otherwise). This is the one check of the arguments: any
// other (mode, tile, acc), D not a multiple of 32, value or out off a
// 16-byte boundary (the float4 loads and stores), a payload larger than
// shared memory or B*H above grid y's 65535 returns cudaErrorInvalidValue,
// which the wrapper raises.
extern "C" int msda_fwd_ho(const void* value, const void* loc, const void* attw, void* out,
                           const void* level_hw, int L, int B, int K, int Q, int H, int D,
                           int P, int mode, int tile, int acc, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D % 32 != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)value | (uintptr_t)out) % 16 != 0) return (int)cudaErrorInvalidValue;
  const bool full = mode == kFull && (tile == 8 || tile == 16 || tile == 32 || tile == 64) &&
                    (acc == 1 || acc == 2);
  const bool probe = (mode == kGather || mode == kWeights || mode == kNoop) &&
                     tile == kHoTile && acc == 1;
  if (!full && !probe) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile * L * P * (sizeof(int4) + sizeof(float4));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const Levels lv = load_levels(level_hw, L);
  if ((int64_t)B * Q * H == 0) return (int)cudaSuccess;
  const float* v = static_cast<const float*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode * 10 + acc) {
    case kFull * 10 + 1: return launch_acc<kFull, 1>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
    case kFull * 10 + 2: return launch_acc<kFull, 2>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
    case kGather * 10 + 1: return launch_acc<kGather, 1>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
    case kWeights * 10 + 1: return launch_acc<kWeights, 1>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
    default: return launch_acc<kNoop, 1>(v, lo, a, o, lv, B, K, Q, H, D, L, P, tile, smem, s);
  }
}
