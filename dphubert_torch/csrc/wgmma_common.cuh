// What the tensor-core attention bodies share (attention_fwd.cu's forward
// and attention_bwd_wgmma.cuh's dq and dkv): bf16 tiles at head_dim 64 in
// 128-byte-swizzled shared memory, filled by 16-byte cp.async; the wgmma
// shared-memory descriptors; wgmma.mma_async m64n64k16 with A from shared
// memory or from registers; and the accumulator's fragment written out as
// bf16 rows.
//
// Tiles are 64 rows of 128 bytes, 1024-byte aligned, 16-byte chunk c of row
// r stored at chunk c ^ (r % 8): the layout the descriptors' SWIZZLE_128B
// mode reads.  Rows past L are zero-filled.
//
// The accumulator's fragment: thread t of the warpgroup (warp w = t / 32,
// lane l) holds d[i], i = e + 2 h + 4 j (e, h in {0, 1}, j in 0..7), of row
// 16 w + l / 4 + 8 h and column 8 j + 2 (l % 4) + e.  That is also the
// register layout of a bf16 A operand for k-step kk: registers 4 kk .. 4 kk
// + 3 are the pairs (d[2 n], d[2 n + 1]), n = 4 kk .. 4 kk + 3, so a product
// of a score tile goes from its accumulator to the A operand of the next
// product in place, without shared memory.
#pragma once

#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kWgD = 64;         // head_dim: a row is 128 bytes, one swizzle atom
constexpr int kWgRows = 64;      // rows of a tile: wgmma's M
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kWgStages = 2;     // ring depth of the streamed tiles
constexpr uint32_t kWgTile = kWgRows * kWgD * 2;       // bytes of a bf16 tile
constexpr uint32_t kWgRing = kWgStages * 2 * kWgTile;  // two tiles a stage
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// cp.async with src-size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's completed cp.async writes visible to the async proxy
// that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows r0 .. r0 + 63 of a (row, 64) bf16 slice into a swizzled tile at
// shared address dst: 4 chunks of 16 bytes a thread, 8 threads a row.
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride, int r0,
                                                int L, int tid) {
  const int c = tid & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 16 * i;
    const int row = r0 + r;
    const bool ok = row < L;
    cp_async16(dst + swizzled(r, c),
               src + (ok ? row * row_stride : 0LL) + 8 * c, ok);
  }
}

// wgmma shared-memory descriptor, SWIZZLE_128B: start address, leading and
// stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// A tile as a K-major operand (64 rows x 16 columns a k-step; the 8-row
// groups 1024 bytes apart): k-step kk starts 32 kk bytes in (+2 kk here).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile) {
  return make_desc(tile, 16, 1024);
}
// A tile as an MN-major B operand (16 rows of K x 64 columns of N a
// k-step; 8-row groups 1024 bytes apart): k-step kk starts 2048 kk bytes in
// (+128 kk here).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile) {
  return make_desc(tile, 128, 1024);
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
// keeps the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DPH_WGMMA_D                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DPH_WGMMA_D_OPERANDS(d)                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d = A B (accumulate 0) or d += A B, m64n64k16, A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DPH_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DPH_WGMMA_D_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (4 bf16 pairs a thread), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DPH_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DPH_WGMMA_D_OPERANDS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef DPH_WGMMA_D
#undef DPH_WGMMA_D_OPERANDS

// the bf16 A-operand pair (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// Writes an accumulator's rows (row0 + r for r in the fragment, those < L)
// as bf16 pairs into a (row, 64) slice.
__device__ __forceinline__ void store_rows(const float (&d)[32],
                                           __nv_bfloat16* dst,
                                           long long row_stride, int row0,
                                           int L, int tid) {
  const int r = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c = 2 * (tid & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * row_stride + 8 * j + c) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// The tensor-core bodies read rows with 16-byte copies and write bf16
// pairs: their dispatch refuses other pointers and strides.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
inline bool rows_of_8(const Strides& s) {
  return s.batch % 8 == 0 && s.row % 8 == 0 && s.head % 8 == 0;
}

}  // namespace
