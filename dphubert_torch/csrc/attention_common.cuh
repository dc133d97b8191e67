// Device code shared by attention_fwd.cu and attention_bwd.cu: tile sizes,
// type conversions, the finite mask value and the counter-hash dropout mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockKV + 1;  // padded row of a 64x64 score tile
// -0.7 * FLT_MAX: the finite mask value of the Pallas kernels.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p rounded to the input type, as the Pallas kernel's p.astype(v.dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Element strides of a (batch, row, head) view; the head's D values are
// contiguous.
struct Strides {
  long long batch, row, head;
};

// Attention-probability dropout, off when seed is null.  seed points at one
// int32 on the card (read in the kernel, so drawing it needs no host sync);
// an element is kept when its hash is <= threshold, the host's
// uint32(keep * 4294967295.0); kept probabilities are scaled by inv_keep.
struct Dropout {
  const int* seed;
  unsigned threshold;
  float inv_keep;
};

// Replaces ops/flash_attention.py::_dropout_keep_mask of the TPU package:
// a murmur3-finalizer hash of (seed + b*0x9E3779B1 + h*0x85EBCA77, absolute
// query row, absolute key column) in uint32 arithmetic, bit for bit.  The
// head id is global.  Every kernel that regenerates the mask calls this, so
// the mask is never stored.
__device__ __forceinline__ unsigned dropout_bh_seed(const int* seed, int b,
                                                    int h) {
  return static_cast<unsigned>(*seed) + static_cast<unsigned>(b) * 0x9E3779B1u +
         static_cast<unsigned>(h) * 0x85EBCA77u;
}
__device__ __forceinline__ bool dropout_keep(unsigned bh_seed, unsigned row,
                                             unsigned col, unsigned threshold) {
  unsigned x = (row * 0x27D4EB2Fu) ^ (col * 0x165667B1u) ^ bh_seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x <= threshold;
}

// One attribute call per kernel instantiation: dynamic shared memory above
// 48 KB has to be opted into.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

}  // namespace
