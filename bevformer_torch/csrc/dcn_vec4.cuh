// Four consecutive channels of a channels-last map, fp32 or bf16, as the
// DCN sampling kernels (csrc/dcn_im2col.cu, csrc/dcn_col2im.cu) read and
// write them: one 16-byte access of fp32, or one 8-byte access of bf16
// widened to fp32 exactly (a bf16 is the top half of the fp32 of the same
// value) and rounded back to nearest even, once, on the way out. The
// arithmetic between is fp32 for both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// four bf16 (8 bytes) widened to fp32
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// streaming stores (evict first): written once, read by a later kernel
__device__ __forceinline__ void stcs4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ void stcs4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                 *reinterpret_cast<const unsigned*>(&hi)));
}

}  // namespace
