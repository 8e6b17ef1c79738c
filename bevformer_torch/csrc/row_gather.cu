// Row gather, for Hopper (sm_90a): out[b, r, :] = src[b, idx[b, r], :].
//
// Replaces: the Pallas TPU probe tools/bench_dma_gather.py::_gather_kernel
// (launched from pallas_gather), which issues one HBM->VMEM DMA per row
// with a ring of semaphores, to beat the TPU's slow XLA gather on the
// [6, 40960, 256] bf16 row permutes around the SCA kernel.
//
// What bounds it on this card: bytes. Each output row is one read of a
// source row and one write; there is no arithmetic, so the least time is
// (src read + idx read + out write) at the card's memory rate. Random rows
// of 512 bytes (bf16) or 1 KiB (fp32) are whole DRAM bursts, so a random
// order need not cost bandwidth if enough reads are in flight.
//
// What the design does about it: one warp per output row; every lane reads
// the row's index (a broadcast load) and copies 16-byte vectors, so a
// 512-byte row is one 16-byte load and store per lane, coalesced. Eight
// warps per block and many blocks per SM keep enough loads in flight. The
// kernel moves bytes and knows no dtype: the wrapper passes the row's byte
// width, which must be a multiple of 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_kernel(const uint4* __restrict__ src,  // [B, M, vecs]
                  const int* __restrict__ idx,    // [B, R]
                  uint4* __restrict__ out,        // [B, R, vecs]
                  int M, int R, int vecs, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t b = r / R;
  const uint4* s = src + (b * M + idx[r]) * vecs;
  uint4* o = out + r * vecs;
  for (int v = lane; v < vecs; v += 32) o[v] = s[v];
}

}  // namespace

extern "C" int row_gather(const void* src, const void* idx, void* out, int B, int M, int R,
                          int row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * R;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  row_gather_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(idx), static_cast<uint4*>(out),
      M, R, row_bytes / 16, rows);
  return (int)cudaGetLastError();
}
