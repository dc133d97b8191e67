// Tensor-core bodies of the attention backward: bf16 inputs at head_dim 64,
// the dtype and width of every training step that reaches attention_bwd.cu
// on the card.  attention_bwd.cu's dispatch picks them for (bf16, 64); fp32
// and D = 80 keep the CUDA-core bodies there.
//
// One warpgroup (128 threads) per block owns a 64-row tile (q rows in dq,
// KV rows in dkv) and issues every product as wgmma.mma_async m64n64k16
// (bf16 operands, fp32 accumulators in registers):
//   dq:  S = Q K^T and dP = dO V^T, both operands K-major in shared memory;
//        dS in registers, then dQ += dS K with dS as the register A operand
//        and K read MN-major from the same tile;
//   dkv: S^T = K Q^T and dP^T = V dO^T; P~^T and dS^T in registers, then
//        dV += P~^T dO and dK += dS^T Q, dO and Q read MN-major.
// The resident tiles (Q and dO in dq, K and V in dkv) load once; the
// streamed ones (K and V, or Q and dO with their rows' m, l and di) go
// through a two-stage ring filled with 16-byte cp.async, the next tile
// loading while this one is multiplied.  Tiles are bf16 in shared memory,
// 64 rows of 128 bytes, 1024-byte aligned and 128-byte swizzled (16-byte
// chunk c of row r stored at chunk c ^ (r % 8)), the layout the wgmma
// descriptors' SWIZZLE_128B mode reads; rows past L are zero-filled.
//
// The accumulator's fragment: thread t of the warpgroup (warp w = t / 32,
// lane l) holds d[i], i = e + 2 h + 4 j (e, h in {0, 1}, j in 0..7), of row
// 16 w + l / 4 + 8 h and column 8 j + 2 (l % 4) + e.  That is also the
// register layout of a bf16 A operand for k-step kk: registers 4 kk .. 4 kk
// + 3 are the pairs (d[2 n], d[2 n + 1]), n = 4 kk .. 4 kk + 3, so P~ and dS
// go from the S-side accumulators to the A operand of the next product in
// place, without shared memory.  P~ and dS * scale are rounded to bf16
// there (the plain versions round at the same two points for bf16 inputs).
//
// Each block waits on its own products (S and dP, then the second pair),
// so the SM overlaps one block's exponentials and hash with another's
// products: the bodies are bound by latency and by how many blocks fit.
// Registers set that (dq 123 a thread: 4 blocks an SM; dkv 166: 3), so
// nothing here may cost registers for overlap inside a block: splitting
// the waits (P while dP multiplies) took more of them, fit fewer blocks
// and ran slower.
#pragma once

#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kWgD = 64;         // head_dim: a row is 128 bytes, one swizzle atom
constexpr int kWgRows = 64;      // rows of a tile: wgmma's M
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kWgStages = 2;     // ring depth of the streamed tiles
constexpr uint32_t kWgTile = kWgRows * kWgD * 2;       // bytes of a bf16 tile
constexpr uint32_t kWgStats = 3 * kWgRows * 4;         // m, l (or 1/l), di of 64 rows
constexpr uint32_t kWgRing = kWgStages * 2 * kWgTile;  // two tiles a stage
// shared memory of a block, bytes: two resident tiles, the ring, the
// statistics (one set in dq, one per stage in dkv) and 1024 bytes of slack
// to align the base
constexpr uint32_t kWgDqSmem = 2 * kWgTile + kWgRing + kWgStats + 1024;
constexpr uint32_t kWgDkvSmem = 2 * kWgTile + kWgRing + kWgStages * kWgStats + 1024;
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

// dq and di for one (64-row q tile, head, batch); arguments as
// attention_bwd_dq_kernel's.
__global__ void __launch_bounds__(kWgThreads)
    attention_bwd_dq_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ out,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
        const float* __restrict__ l_in, float* __restrict__ di_out,
        __nv_bfloat16* __restrict__ dq, const int* __restrict__ lengths, int H,
        int L, Strides in, Strides os, Strides gs, float scale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + kWgTile;
  const uint32_t ring = base + 2 * kWgTile;  // stage s: K at ring + 2 s kWgTile, V after it
  float* stats = reinterpret_cast<float*>(wg_smem + (base - raw) + 2 * kWgTile + kWgRing);
  float* sM = stats;
  float* sLinv = stats + kWgRows;
  float* sDi = stats + 2 * kWgRows;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int len = L;
  if (lengths != nullptr) len = max(0, min(lengths[b], L));
  const int kv_end = len > 0 ? len : L;
  const int n_kv = (kv_end + kWgRows - 1) / kWgRows;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long ibase = (long long)b * in.batch + (long long)h * in.head;
  const long long obase = (long long)b * os.batch + (long long)h * os.head;
  const __nv_bfloat16* kb = k + ibase;
  const __nv_bfloat16* vb = v + ibase;

  // the first group: Q, dO and the first K, V tile
  load_tile_async(sQ, q + ibase, in.row, q0, L, tid);
  load_tile_async(sdO, dout + obase, os.row, q0, L, tid);
  load_tile_async(ring, kb, in.row, 0, L, tid);
  load_tile_async(ring + kWgTile, vb, in.row, 0, L, tid);
  cp_async_commit();

  // prologue: di = rowsum(out * dout), 2 threads a row, 16-byte loads; rows
  // past L get p = 0 through 1/l = 0
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < L) {
      const long long off = obase + row * os.row + 32 * half;
      const uint4* po = reinterpret_cast<const uint4*>(out + off);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 a = po[i], c = pd[i];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(a2[j]), y = __bfloat1622float2(c2[j]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const long long idx = ((long long)b * H + h) * L + row;
      float m = 0.f, l_inv = 0.f;
      if (row < L) {
        di_out[idx] = acc;
        m = m_in[idx];
        const float l = l_in[idx];
        l_inv = l == 0.f ? 1.f : 1.f / l;
      }
      sDi[r] = acc;
      sM[r] = m;
      sLinv[r] = l_inv;
    }
  }
  __syncthreads();

  // this thread's two rows of every accumulator, and its column pair
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int cpair = 2 * (tid & 3);
  float m_r[2], li_r[2], di_r[2];
  unsigned row_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    m_r[hh] = sM[r];
    li_r[hh] = sLinv[r];
    di_r[hh] = sDi[r];
    row_r[hh] = q0 + r;
  }

  float acc_dq[32], s[32], dp[32];
  zero(acc_dq);
  zero(s);
  zero(dp);
  const uint64_t dQ = desc_k_major(sQ), ddO = desc_k_major(sdO);

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {  // stage (t + 1) % 2 was released at the end of t - 1
      const uint32_t next = ring + ((t + 1) & 1) * 2 * kWgTile;
      load_tile_async(next, kb, in.row, (t + 1) * kWgRows, L, tid);
      load_tile_async(next + kWgTile, vb, in.row, (t + 1) * kWgRows, L, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = ring + (t & 1) * 2 * kWgTile, sV = sK + kWgTile;
    const uint64_t dK = desc_k_major(sK), dV = desc_k_major(sV);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dQ + 2 * kk, dK + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, ddO + 2 * kk, dV + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    // dS = P (dP~ - di) scale in place of S, packed into bf16 A pairs
    const int kv0 = t * kWgRows;
    uint32_t a[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const int col = kv0 + 8 * j + cpair + e;
          const float x = col < len ? s[i] * scale : kNegInf;
          const float p = col < L ? exp2f((x - m_r[hh]) * kLog2e) * li_r[hh] : 0.f;
          float dpv = dp[i];
          if (dropout)
            dpv = dropout_keep(bh_seed, row_r[hh], col, drop.threshold)
                      ? dpv * drop.inv_keep : 0.f;
          ds[e] = p * (dpv - di_r[hh]) * scale;
        }
        a[2 * j + hh] = pack_bf16(ds[0], ds[1]);
      }
    }

    wgmma_fence();
    const uint64_t dKt = desc_mn_major(sK);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_dq, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
               dKt + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc_dq);
    __syncthreads();  // every thread is done with stage t % 2
  }
  cp_async_wait<0>();

  const long long gbase = (long long)b * gs.batch + (long long)h * gs.head;
  store_rows(acc_dq, dq + gbase, gs.row, q0, L, tid);
}

// dk and dv for one (64-row KV tile, head, batch); arguments as
// attention_bwd_dkv_kernel's.
__global__ void __launch_bounds__(kWgThreads)
    attention_bwd_dkv_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
        const float* __restrict__ l_in, const float* __restrict__ di_in,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        const int* __restrict__ lengths, int H, int L, Strides in, Strides os,
        Strides gs, float scale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + kWgTile;
  const uint32_t ring = base + 2 * kWgTile;  // stage s: Q at ring + 2 s kWgTile, dO after it
  const uint32_t stat_addr = base + 2 * kWgTile + kWgRing;  // stage s at + s kWgStats
  const float* stats = reinterpret_cast<const float*>(wg_smem + (stat_addr - raw));

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int len = L;
  if (lengths != nullptr) len = max(0, min(lengths[b], L));
  const int kv_end = len > 0 ? len : L;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long ibase = (long long)b * in.batch + (long long)h * in.head;
  const long long obase = (long long)b * os.batch + (long long)h * os.head;
  const long long sbase = ((long long)b * H + h) * L;
  const __nv_bfloat16* qb = q + ibase;
  const __nv_bfloat16* ob = dout + obase;

  // m and di by threads 0-63, l by threads 64-127, one row each; rows past
  // L read as 0 (their Q and dO rows are 0 as well, and 1/l is set to 0)
  auto load_stats = [&](uint32_t dst, int q0) {
    const int r = tid & 63, row = q0 + r;
    const bool ok = row < L;
    const long long idx = sbase + (ok ? row : 0);
    if (tid < 64) {
      cp_async4(dst + 4 * r, m_in + idx, ok);
      cp_async4(dst + 8 * kWgRows + 4 * r, di_in + idx, ok);
    } else {
      cp_async4(dst + 4 * kWgRows + 4 * r, l_in + idx, ok);
    }
  };

  float acc_dk[32], acc_dv[32];
  zero(acc_dk);
  zero(acc_dv);

  // a tile wholly past the valid keys has p = 0 in every row: zeros
  if (kv0 < kv_end) {
    const int n_q = (L + kWgRows - 1) / kWgRows;
    load_tile_async(sK, k + ibase, in.row, kv0, L, tid);
    load_tile_async(sV, v + ibase, in.row, kv0, L, tid);
    load_tile_async(ring, qb, in.row, 0, L, tid);
    load_tile_async(ring + kWgTile, ob, os.row, 0, L, tid);
    load_stats(stat_addr, 0);
    cp_async_commit();

    // this thread's two KV rows (the key columns of the scores)
    const int c_lo = 16 * (tid >> 5) + ((tid & 31) >> 2);
    const int cpair = 2 * (tid & 3);
    int col_r[2];
    bool valid_r[2], in_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      col_r[hh] = kv0 + c_lo + 8 * hh;
      valid_r[hh] = col_r[hh] < len;
      in_r[hh] = col_r[hh] < L;
    }
    const uint64_t dK = desc_k_major(sK), dV = desc_k_major(sV);
    float s[32], dp[32];
    zero(s);
    zero(dp);

    for (int t = 0; t < n_q; ++t) {
      if (t + 1 < n_q) {  // stage (t + 1) % 2 was released at the end of t - 1
        const int nxt = (t + 1) & 1;
        const uint32_t next = ring + nxt * 2 * kWgTile;
        load_tile_async(next, qb, in.row, (t + 1) * kWgRows, L, tid);
        load_tile_async(next + kWgTile, ob, os.row, (t + 1) * kWgRows, L, tid);
        load_stats(stat_addr + nxt * kWgStats, (t + 1) * kWgRows);
      }
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed
      fence_proxy_async();
      __syncthreads();

      const uint32_t sQ = ring + (t & 1) * 2 * kWgTile, sdO = sQ + kWgTile;
      const float* st = stats + (t & 1) * (kWgStats / 4);
      wgmma_fence();
      const uint64_t dQ = desc_k_major(sQ), ddO = desc_k_major(sdO);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dK + 2 * kk, dQ + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, dV + 2 * kk, ddO + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);

      // P~^T and dS^T in place of S^T and dP^T, packed into bf16 A pairs;
      // the columns are this q tile's rows
      const int q0 = t * kWgRows;
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 8 * j + cpair;
        const float2 m2 = *reinterpret_cast<const float2*>(st + r);
        const float2 l2 = *reinterpret_cast<const float2*>(st + kWgRows + r);
        const float2 di2 = *reinterpret_cast<const float2*>(st + 2 * kWgRows + r);
        const float mv[2] = {m2.x, m2.y}, lv[2] = {l2.x, l2.y}, dv_[2] = {di2.x, di2.y};
        float li[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          li[e] = q0 + r + e < L ? (lv[e] == 0.f ? 1.f : 1.f / lv[e]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pu[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const unsigned row = q0 + r + e;
            const float x = valid_r[hh] ? s[i] * scale : kNegInf;
            const float p = in_r[hh] ? exp2f((x - mv[e]) * kLog2e) * li[e] : 0.f;
            float p_used = p, dpv = dp[i];
            if (dropout) {
              const bool keep = dropout_keep(bh_seed, row, col_r[hh], drop.threshold);
              p_used = keep ? p * drop.inv_keep : 0.f;
              dpv = keep ? dpv * drop.inv_keep : 0.f;
            }
            pu[e] = p_used;
            ds[e] = p * (dpv - dv_[e]) * scale;
          }
          pa[2 * j + hh] = pack_bf16(pu[0], pu[1]);
          da[2 * j + hh] = pack_bf16(ds[0], ds[1]);
        }
      }

      wgmma_fence();
      const uint64_t dOt = desc_mn_major(sdO), dQt = desc_mn_major(sQ);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], dOt + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                 da[4 * kk + 3], dQt + 128 * kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc_dv);
      fence_acc(acc_dk);
      __syncthreads();  // every thread is done with stage t % 2
    }
    cp_async_wait<0>();
  }

  const long long gbase = (long long)b * gs.batch + (long long)h * gs.head;
  store_rows(acc_dk, dk + gbase, gs.row, kv0, L, tid);
  store_rows(acc_dv, dv + gbase, gs.row, kv0, L, tid);
}

}  // namespace
