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
// loading while this one is multiplied.  The tiles' swizzled layout, the
// descriptors and the accumulator's fragment are wgmma_common.cuh's: P~
// and dS go from the S-side accumulators to the A operand of the next
// product in place, without shared memory, rounded to bf16 there (the
// plain versions round at the same two points for bf16 inputs).
//
// Each block waits on its own products (S and dP, then the second pair),
// so the SM overlaps one block's exponentials and hash with another's
// products: the bodies are bound by latency and by how many blocks fit.
// Registers set that (dq 123 a thread: 4 blocks an SM; dkv 166: 3), so
// nothing here may cost registers for overlap inside a block: splitting
// the waits (P while dP multiplies) took more of them, fit fewer blocks
// and ran slower.
#pragma once

#include "wgmma_common.cuh"

namespace {

constexpr uint32_t kWgStats = 3 * kWgRows * 4;  // m, l (or 1/l), di of 64 rows
// shared memory of a block, bytes: two resident tiles, the ring, the
// statistics (one set in dq, one per stage in dkv) and 1024 bytes of slack
// to align the base
constexpr uint32_t kWgDqSmem = 2 * kWgTile + kWgRing + kWgStats + 1024;
constexpr uint32_t kWgDkvSmem = 2 * kWgTile + kWgRing + kWgStages * kWgStats + 1024;

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
