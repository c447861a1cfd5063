// Shared pieces of the bf16 flash-attention kernels for Hopper (sm_90a).
//
// Layout: every tensor is a contiguous [BH, T, D] slab (BH = batch * heads),
// q/k/v/o/do in bf16, lse/delta/dq-scratch in fp32. The ragged head
// columns and sequence rows are zero-filled in shared memory only (device
// memory stays unpadded).
//
// Every kernel is warp-specialised: tiles loaded by TMA (or staged where
// TMA cannot describe the slab) into shared memory with mbarriers, and
// warpgroups that run the products on wgmma (hopper.cuh holds the
// primitives and the shared-memory layout).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

// The Hopper kernels' TMA route needs rows of a multiple of 16 bytes and
// 16-byte aligned bases (the caller chooses; this only refuses a wrong
// choice).
inline bool tma_ok(int d, int tma, const void* a, const void* b, const void* c,
                          const void* e) {
  if (!tma) return true;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e);
  return d % 8 == 0 && bases % 16 == 0;
}

// Head width rounded up to a wide kernel's: a multiple of 64, so that a
// quarter of it is whole 16-column tiles (0: unsupported).
inline int wide_dmax(int d) {
  if (d <= 0) return 0;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  if (d <= 256) return 256;
  if (d <= 512) return 512;
  return 0;
}

// A descriptor moved `bytes` further into shared memory: its address field
// holds (address >> 4) in 14 bits, and no shared address reaches 2^18, so
// the addition never carries out of the field.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
