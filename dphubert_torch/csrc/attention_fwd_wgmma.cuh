// The tensor-core attention forward (bf16 at head_dim 64), one body for two
// sources: attention_fwd.cu's packed and flash forward
// (attention_fwd_wgmma_kernel, kGatedBias = false) and WavLM's gated-bias
// forward (wavlm_attention_wgmma.cuh's wavlm_fwd_wgmma_kernel, kGatedBias =
// true, s += gate[b, h, i] * bias[h, i, j]).
//
// One warpgroup (128 threads) per (64-row q tile, head, batch); the caller's
// kernel maps its block to those indices.  The Q tile is resident; K and V
// tiles stream through a two-stage ring of 16-byte cp.async into
// 128-byte-swizzled bf16 tiles, tile t + 1 loading while tile t is
// multiplied (wgmma_common.cuh).  S = Q K^T is four wgmma m64n64k16 with
// both operands K-major; the online softmax runs on S's accumulator in
// registers (a row's 64 columns on the four lanes of a quad: the row max and
// sum take 16 local values, then two shuffles); the unnormalised p, rounded
// to bf16 and dropped where the hash drops it, is packed in place into the A
// operand of O += P V, four wgmma with A from registers and V read MN-major
// from the tile just landed.  P never goes through shared memory.  exp is
// exp2 of (x - m) log2(e); m stays in the units of x, as the backward bodies
// read it.
//
// With the gated bias: each thread's 32 fp32 bias entries of a KV tile (its
// two rows, its column pairs) are loaded from device memory into registers
// with 4-byte __ldg one tile ahead: tile t + 1's after the P V products of
// tile t are issued and before they are waited on (tile 0's before the
// loop), so the loads hide behind the products, the softmax and the next
// tile's wait (the (H, L, L) rows are only 4-byte aligned for odd L, so no
// wider copy can read them; rows and columns past L read nothing, and a
// row past L has gate 0).  Loaded during S instead (the backward dq body's
// placement) it ran 3-5% slower with 5 more registers (PERF.md).  The bias
// joins S's fragment before the key mask as x = fmaf(gate, bias, s *
// scale), exactly as wavlm_attention_wgmma.cuh's backward bodies form it:
// they recompute p from the m and l written here.  The gate is read once
// per row.  Without the bias the body compiles to attention_fwd.cu's own
// (the bias code is `if constexpr`).
//
// What bounds it with the bias: each batch row's block reads its bias rows
// again, from L2 where the B blocks of a tile run together, so the bias
// moves B times its size from L2 to the SMs (431 MB at the DPWavLM step's
// shape, against 27 MB from device memory): the cost over the unbiased
// body.
#pragma once

#include "wgmma_common.cuh"

namespace {

// shared memory of the tensor-core forward, bytes: the resident Q tile, the
// ring of K and V tiles and 1024 bytes of slack to align the base
constexpr uint32_t kWgFwdSmem = kWgTile + kWgRing + 1024;

// WavLM's gated bias: bias (H, L, L) and gate (B, H, L), contiguous fp32
struct GatedBias {
  const float* bias;
  const float* gate;
};

// q, k, v: (row, 64) slices at element strides `in` (batch, row, head);
// out at strides `os`; m_out, l_out contiguous (B, H, L) fp32, or null;
// lengths (B,) int32 or null; q_tile, h, b: this block's indices.
template <bool kGatedBias>
__device__ __forceinline__ void attention_fwd_wgmma_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    const int* __restrict__ lengths, int H, int L, Strides in, Strides os,
    float scale, Dropout drop, GatedBias gb, int q_tile, int h, int b) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t ring = base + kWgTile;  // stage s: K at ring + 2 s kWgTile, V after it

  const int tid = threadIdx.x;
  const int q0 = q_tile * kWgRows;

  int len = L;
  if (lengths != nullptr) len = max(0, min(lengths[b], L));
  // Tiles past the valid keys hold only masked columns: skip them, except
  // for a row with no valid key, which averages over all of them.
  const int kv_end = len > 0 ? len : L;
  const int n_kv = (kv_end + kWgRows - 1) / kWgRows;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long ibase = (long long)b * in.batch + (long long)h * in.head;
  const __nv_bfloat16* kb = k + ibase;
  const __nv_bfloat16* vb = v + ibase;

  // the first group: Q and the first K, V tile
  load_tile_async(sQ, q + ibase, in.row, q0, L, tid);
  load_tile_async(ring, kb, in.row, 0, L, tid);
  load_tile_async(ring + kWgTile, vb, in.row, 0, L, tid);
  cp_async_commit();

  // this thread's two rows of every accumulator, and its column pair
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int cpair = 2 * (tid & 3);
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  // with the gated bias: the rows' gates and bias rows (rows past L: gate
  // 0, the pointer clamped to row L - 1 and never read)
  float g_r[2] = {0.f, 0.f};
  bool row_ok[2] = {false, false};
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (kGatedBias) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r_lo + 8 * hh;
      row_ok[hh] = row < L;
      g_r[hh] = row_ok[hh] ? gb.gate[((long long)b * H + h) * L + row] : 0.f;
      brow[hh] = gb.bias + ((long long)h * L + min(row, L - 1)) * L;
    }
  }
  float s[32], acc[32];
  zero(s);
  zero(acc);
  const uint64_t dQ = desc_k_major(sQ);
  // with the gated bias: the bias entries of the KV tile at kv0 (this
  // thread's rows and columns of S's fragment; none past L), one tile ahead
  float bv[32];
  auto load_bias = [&](int kv0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + 8 * j + cpair + e;
          bv[4 * j + 2 * hh + e] = row_ok[hh] && col < L ? __ldg(brow[hh] + col) : 0.f;
        }
  };
  if constexpr (kGatedBias) load_bias(0);

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
    const uint64_t dK = desc_k_major(sK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dQ + 2 * kk, dK + 2 * kk, kk);
    wgmma_commit();
    const int kv0 = t * kWgRows;
    wgmma_wait_all();
    fence_acc(s);

    // the bias term, then the mask, then each row's max over its quad:
    // columns past L do not exist (excluded); columns past the length get
    // the finite NEG_INF, as in the Pallas kernels
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const int col = kv0 + 8 * j + cpair + e;
          float x = s[i] * scale;
          if constexpr (kGatedBias) x = fmaf(g_r[hh], bv[i], x);
          x = col < len ? x : kNegInf;
          x = col < L ? x : -CUDART_INF_F;
          s[i] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_next = fmaxf(m_r[hh], mx[hh]);  // finite: column 0 < L
      alpha[hh] = exp2f((m_r[hh] - m_next) * kLog2e);
      m_r[hh] = m_next;
    }

    // p = exp(x - m), summed undropped, then dropped and packed in place
    // into bf16 A pairs (rounded there, as round_to<bf16> rounds it)
    uint32_t a[16];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float kept[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const unsigned row = q0 + r_lo + 8 * hh;
          const unsigned col = kv0 + 8 * j + cpair + e;
          const float p = exp2f((s[i] - m_r[hh]) * kLog2e);
          sum[hh] += p;
          kept[e] = dropout && !dropout_keep(bh_seed, row, col, drop.threshold) ? 0.f : p;
        }
        a[2 * j + hh] = pack_bf16(kept[0], kept[1]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l_r[hh] = alpha[hh] * l_r[hh] + sum[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

    wgmma_fence();
    const uint64_t dVt = desc_mn_major(sV);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
               dVt + 128 * kk);
    wgmma_commit();
    if constexpr (kGatedBias) load_bias(kv0 + kWgRows);  // the next tile's, while P V runs
    wgmma_wait_all();
    fence_acc(acc);
    __syncthreads();  // every thread is done with stage t % 2
  }
  cp_async_wait<0>();

  float l_inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l_inv[hh] = (l_r[hh] == 0.f ? 1.f : 1.f / l_r[hh]) * drop.inv_keep;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= l_inv[(i >> 1) & 1];
  const long long obase = (long long)b * os.batch + (long long)h * os.head;
  store_rows(acc, out + obase, os.row, q0, L, tid);
  if (m_out != nullptr && (tid & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r_lo + 8 * hh;
      if (row >= L) continue;
      const long long idx = ((long long)b * H + h) * L + row;
      m_out[idx] = m_r[hh];
      l_out[idx] = l_r[hh];
    }
  }
}

}  // namespace
