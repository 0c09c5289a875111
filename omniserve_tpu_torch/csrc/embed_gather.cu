// Embedding row gather for the decode step, for Hopper (sm_90a).
//
// Replaces the TPU kernel omniserve_tpu/ops/pallas/embed_gather.py:
//   embed_gather (:46, kernel _kernel :26): out[b] = table[clamp(ids[b], 0,
//   V - 1)], one async row DMA per token on the TPU.
//
// Contract (plain version: ops/cuda/embed_gather.embed_gather_plain):
//   table [V, D] bf16 or f32, contiguous, rows a multiple of 16 bytes; ids
//   [B] int32 or int64; out [B, D] of the table's dtype. An id below 0 reads
//   row 0, an id of V or more row V - 1 (the TPU wrapper's clip, :53).
//
// What bounds it: bytes (each output row read once from the table and
// written once: 2 * B * D * element size, plus the ids).
// Design: a grid of (B, row chunks) blocks of 128 threads; each thread
// copies one 16-byte vector of one row with a 16-byte load and store, so a
// warp moves 512 contiguous bytes. No host sync and no allocation: the
// launch captures into a CUDA graph (the decode windows replay it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

template <typename Id>
__global__ void __launch_bounds__(NT) embed_gather_kernel(
    const uint4* __restrict__ table, const Id* __restrict__ ids,
    uint4* __restrict__ out, long long V, int row_vecs) {
  const int b = blockIdx.x;
  const int i = blockIdx.y * NT + threadIdx.x;
  if (i >= row_vecs) return;
  long long id = (long long)ids[b];
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);
  out[(size_t)b * row_vecs + i] = table[id * row_vecs + i];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). row_bytes:
// bytes of one table row (a multiple of 16); id_bytes: 4 (int32) or 8
// (int64).
int launch_embed_gather(const void* table, const void* ids, void* out,
                        long long V, int row_bytes, int B, int id_bytes,
                        void* stream) {
  if (V <= 0 || B <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      (id_bytes != 4 && id_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  dim3 grid(B, (row_vecs + NT - 1) / NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4)
    embed_gather_kernel<int32_t><<<grid, NT, 0, s>>>(
        static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
        static_cast<uint4*>(out), V, row_vecs);
  else
    embed_gather_kernel<int64_t><<<grid, NT, 0, s>>>(
        static_cast<const uint4*>(table), static_cast<const int64_t*>(ids),
        static_cast<uint4*>(out), V, row_vecs);
  return (int)cudaGetLastError();
}

}  // extern "C"
