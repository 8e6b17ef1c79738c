// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel bevformer_tpu/kernels/msda_hi.py::_kernel_hi
// (launched from _forward_hi and _forward_hi_lw), which computes the op as
// windowed multi-hot matmuls because the TPU has no fast gather. The
// function is bevformer_tpu/kernels/msda.py::ms_deform_attn_jnp: for each
// (b, q, h) sum over (level, point) of attw * bilinear(value_l, loc), with
// pixel = loc * size - 0.5 (grid_sample, align_corners=False) and zeros
// outside the map, accumulated in fp32.
//
// What bounds it on this card: gathers. Each (b, q, h) reads 4 corners x
// L x P rows of D floats from a value map that is scattered in memory; it
// does 2 flops per byte read, far below the card's compute, so the kernel
// is bound by the latency and bandwidth of those reads (L2 holds most of
// the value map at the path's shapes).
//
// What the design does about it: one warp per (b, q, h) with lane = channel
// d, so each bilinear corner is one coalesced 128-byte read of
// value[b, k, h, 0:32] in the [B, K, H, D] layout. There are no windows and
// no sort: the card gathers directly, so the op is exact for any offsets.
// All lanes read the same location and weight (a broadcast load). Many warps
// in flight hide the read latency. No shared memory, no tensor cores.
//
// The body is csrc/msda_fwd.cuh, templated on the probe mode: `msda_fwd`
// runs the msda (kFull) and `msda_fwd_probe` the cost-split modes of the
// heads-inner probe (the counterpart of tools/bench_hi_probe.py's kernel
// variants).

#include "msda_fwd.cuh"

extern "C" int msda_fwd(const void* value, const void* loc, const void* attw,
                        void* out, const void* level_hw, int L, int B, int K,
                        int Q, int H, int D, int P, void* stream) {
  return launch_msda_fwd<kFull>(value, loc, attw, out, level_hw, L, B, K, Q, H, D, P,
                                stream);
}

extern "C" int msda_fwd_probe(const void* value, const void* loc, const void* attw,
                              void* out, const void* level_hw, int L, int B, int K,
                              int Q, int H, int D, int P, int mode, void* stream) {
  switch (mode) {
    case kGather:
      return launch_msda_fwd<kGather>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                      P, stream);
    case kWeights:
      return launch_msda_fwd<kWeights>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                       P, stream);
    case kNoop:
      return launch_msda_fwd<kNoop>(value, loc, attw, out, level_hw, L, B, K, Q, H, D,
                                    P, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
