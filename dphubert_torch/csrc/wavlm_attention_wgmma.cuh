// Tensor-core bodies of WavLM's gated-bias attention: bf16 inputs at
// head_dim 64, the dtype and width of every DPWavLM training step and of
// bf16 WavLM serving on the card.  wavlm_attention.cu's dispatch picks them
// for (bf16, 64) in all seven entries: the forward body for both forward
// entries, the dq and dbias bodies for the fused entry (both, in that
// order) and for the general dq and dbias entries (one each), the dkv body
// for both dkv entries; fp32 and D = 80 keep the CUDA-core bodies there.
//
// The forward (wavlm_fwd_wgmma_kernel) is attention_fwd_wgmma.cuh's body
// with the gated bias: the bias fragment loaded one KV tile ahead, while
// the previous tile's P V multiplies, added as fmaf(gate, bias, s * scale)
// before the key mask, so the m and l it writes are the ones the backward
// bodies below recompute p from.  Its two entries differ only in block
// order (block_tile): batch innermost for wavlm_attention_fwd, so the B
// blocks that read one bias tile run together and hit L2; outermost for
// wavlm_attention_fwd_general.  It is held to 128 registers, 4 blocks an
// SM (ptxas fits it in 122 without a spill; unbounded it takes 128 with the
// prefetch, 153 without, and 3 blocks an SM ran 17% slower at serving's
// shape).
//
// The backward bodies are attention_bwd_wgmma.cuh's dq and dkv bodies (one warpgroup per
// 64-row tile, every product wgmma.mma_async m64n64k16 on 128-byte-swizzled
// bf16 tiles, P~ and dS packed in place from the accumulator into the next
// product's A operand, a two-stage 16-byte cp.async ring), with WavLM's
// three differences:
//   * gate[b,h,i] * bias[h,i,j] is added to S's accumulator fragment before
//     the key mask.  The fp32 bias rows of the (H, L, L) table are only
//     4-byte aligned (L = 749 is odd), so every copy of it is 4 bytes wide.
//     The dq body loads its fragment's entries from device memory into
//     registers while S and dP multiply (the B blocks that share a bias
//     tile run together, batch innermost in the grid, so they hit L2); the
//     dkv body reads the tile transposed, so it stages it in shared memory
//     with 4-byte cp.async one q tile ahead (rows of 68 floats: a warp's
//     transposed reads fall in 32 distinct banks); the dbias body keeps its
//     one tile in registers for all the batch rows;
//   * dgate[b,h,i] = sum_j ds * bias: two fp32 partials a thread (its two
//     rows), over its columns and the KV tiles, then the quad's four summed
//     by shuffles in a fixed order;
//   * dbias[h,i,j] = sum_b gate * ds, a sum over the batch.  The TPU kernel
//     carried it across an inner batch axis of its sequential grid; here a
//     block owns one 64 x 64 (q rows, KV columns) tile of one head and loops
//     over the batch rows in order, recomputing S and dP (two products) for
//     each and adding gate * ds into one fp32 accumulator, written once.
// So the fused entry is two launches on one stream: the dq body (dq, dgate
// and di) and then the dbias body, which reads that di; the general route's
// dq and dbias entries are those two launches apart, called in that order.  No float atomics:
// every sum has one owner and a fixed order, so reruns give the same bits.
// dgate and dbias are summed from the unrounded fp32 ds; only the A
// operands (P~ and scale * ds) are rounded to bf16, as the plain version
// rounds them.  The dbias body holds no strip in shared memory, so it has
// no length limit.
//
// What bounds them: as attention_bwd_wgmma.cuh's bodies, latency and how
// many blocks fit (each block waits on its own products, and the SM
// overlaps one block's exponentials and hash with another's products).  So
// the dq and dkv bodies
// are held to 168 registers, 3 blocks an SM (__launch_bounds__; ptxas fits
// them without a spill); the dbias body (two of the dq body's three
// products per (q tile, KV tile, batch row), its bias tile in 32 registers)
// spills under that bound, so it runs 2 blocks an SM.  The variants measured
// against these choices are in PERF.md (tools/ab_wavlm_bwd.py).
#pragma once

#include "attention_fwd_wgmma.cuh"

namespace {

constexpr uint32_t kWlStats = 4 * kWgRows * 4;  // m, l (or 1/l), di, gate of 64 rows
// the dbias body's ring stage: Q, dO, K, V of one batch row and its q rows'
// statistics (a multiple of 1024 bytes, so every tile stays aligned)
constexpr uint32_t kWlStage = 4 * kWgTile + kWlStats;
// shared memory of a block, bytes, with 1024 bytes of slack to align the base
constexpr uint32_t kWlDqSmem = 2 * kWgTile + kWgRing + kWlStats + 1024;
constexpr uint32_t kWlDbiasSmem = kWgStages * kWlStage + 1024;
// the dkv body's bias tile: 64 q rows of 64 KV columns, rows 68 floats apart
constexpr int kWlBiasStride = 68;
constexpr uint32_t kWlBiasTile = kWgRows * kWlBiasStride * 4;
constexpr uint32_t kWlDkvSmem =
    2 * kWgTile + kWgRing + kWgStages * kWlStats + kWlBiasTile + 1024;
constexpr int kWlBlocksPerSm = 3;  // the dq and dkv bodies' register bound
constexpr int kWlFwdBlocksPerSm = 4;  // the forward's register bound (128)

// the valid keys of batch row b (every body of wavlm_attention.cu)
__device__ __forceinline__ int valid_len(const int* lengths, int b, int L) {
  return lengths != nullptr ? max(0, min(lengths[b], L)) : L;
}

// Where a block's (tile, head, batch) indices come from: the single
// entries put the batch innermost (blockIdx.x), the general ones outermost.
struct Tile {
  int tile, h, b;
};
__device__ __forceinline__ Tile block_tile(bool batch_inner) {
  if (batch_inner) return Tile{(int)blockIdx.y, (int)blockIdx.z, (int)blockIdx.x};
  return Tile{(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
}
inline dim3 tile_grid(int tiles, int H, int B, bool batch_inner) {
  return batch_inner ? dim3(B, tiles, H) : dim3(tiles, H, B);
}

// The forward, both entries: out (contiguous (B, H, L, 64)), m and l
// ((B, H, L) fp32) for one (64-row q tile, head, batch row), blocks in the
// order block_tile gives; q, k, v views with strides `in`; bias (H, L, L)
// and gate (B, H, L) fp32.  attention_fwd_wgmma.cuh's body with the gated
// bias.
__global__ void __launch_bounds__(kWgThreads, kWlFwdBlocksPerSm)
    wavlm_fwd_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ gate, __nv_bfloat16* __restrict__ out,
        float* __restrict__ m_out, float* __restrict__ l_out,
        const int* __restrict__ lengths, int H, int L, Strides in, float scale,
        Dropout drop, bool batch_inner) {
  const Tile t = block_tile(batch_inner);
  const Strides os{(long long)H * L * kWgD, kWgD, (long long)L * kWgD};
  attention_fwd_wgmma_body<true>(q, k, v, out, m_out, l_out, lengths, H, L, in, os, scale, drop,
                                 GatedBias{bias, gate}, t.tile, t.h, t.b);
}

// dq, dgate and di for one (64-row q tile, head, batch row); blockIdx = (b,
// q tile, h).  q, k, v: views with strides `in`; out, dout, dq: contiguous
// (B, H, L, 64); bias (H, L, L), gate, m, l, di, dgate (B, H, L), fp32.
__global__ void __launch_bounds__(kWgThreads, kWlBlocksPerSm)
    wavlm_bwd_dq_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ gate, const __nv_bfloat16* __restrict__ out,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
        const float* __restrict__ l_in, float* __restrict__ di_out,
        __nv_bfloat16* __restrict__ dq, float* __restrict__ dgate,
        const int* __restrict__ lengths, int H, int L, Strides in, float scale,
        Dropout drop) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + kWgTile;
  const uint32_t ring = base + 2 * kWgTile;  // stage s: K at ring + 2 s kWgTile, V after it
  float* stats = reinterpret_cast<float*>(wg_smem + (base - raw) + 2 * kWgTile + kWgRing);
  float* sM = stats;
  float* sLinv = stats + kWgRows;
  float* sDi = stats + 2 * kWgRows;
  float* sG = stats + 3 * kWgRows;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kWgRows;
  const int h = blockIdx.z;

  const int len = valid_len(lengths, b, L);
  const int kv_end = len > 0 ? len : L;
  const int n_kv = (kv_end + kWgRows - 1) / kWgRows;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long ibase = (long long)b * in.batch + (long long)h * in.head;
  const long long srow = ((long long)b * H + h) * L;  // gate, m, l, di, dgate of (b, h)
  const long long obase = srow * kWgD;
  const __nv_bfloat16* kb = k + ibase;
  const __nv_bfloat16* vb = v + ibase;

  // the first group: Q, dO and the first K, V tile
  load_tile_async(sQ, q + ibase, in.row, q0, L, tid);
  load_tile_async(sdO, dout + obase, kWgD, q0, L, tid);
  load_tile_async(ring, kb, in.row, 0, L, tid);
  load_tile_async(ring + kWgTile, vb, in.row, 0, L, tid);
  cp_async_commit();

  // prologue: di = rowsum(out * dout), 2 threads a row, 16-byte loads, and
  // the rows' m, 1/l and gate; rows past L get p = 0 through 1/l = 0
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < L) {
      const long long off = obase + row * kWgD + 32 * half;
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
      float m = 0.f, l_inv = 0.f, g = 0.f;
      if (row < L) {
        di_out[srow + row] = acc;
        m = m_in[srow + row];
        const float l = l_in[srow + row];
        l_inv = l == 0.f ? 1.f : 1.f / l;
        g = gate[srow + row];
      }
      sDi[r] = acc;
      sM[r] = m;
      sLinv[r] = l_inv;
      sG[r] = g;
    }
  }
  __syncthreads();

  // this thread's two rows of every accumulator, their bias rows, and its
  // column pair
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int cpair = 2 * (tid & 3);
  float m_r[2], li_r[2], di_r[2], g_r[2];
  unsigned row_r[2];
  bool row_ok[2];
  const float* brow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    m_r[hh] = sM[r];
    li_r[hh] = sLinv[r];
    di_r[hh] = sDi[r];
    g_r[hh] = sG[r];
    row_r[hh] = q0 + r;
    row_ok[hh] = q0 + r < L;
    brow[hh] = bias + ((long long)h * L + min(q0 + r, L - 1)) * L;
  }

  float acc_dq[32], s[32], dp[32], dg[2] = {0.f, 0.f};
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
    // this tile's bias entries, loaded while the products run
    const int kv0 = t * kWgRows;
    float bv[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + 8 * j + cpair + e;
          bv[4 * j + 2 * hh + e] = row_ok[hh] && col < L ? __ldg(brow[hh] + col) : 0.f;
        }
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    // the bias term joins S here; dgate takes the unscaled ds; scale * ds
    // is packed into bf16 A pairs in place of S
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
          const float x = col < len ? fmaf(g_r[hh], bv[i], s[i] * scale) : kNegInf;
          const float p = col < L ? exp2f((x - m_r[hh]) * kLog2e) * li_r[hh] : 0.f;
          float dpv = dp[i];
          if (dropout)
            dpv = dropout_keep(bh_seed, row_r[hh], col, drop.threshold)
                      ? dpv * drop.inv_keep : 0.f;
          const float d = p * (dpv - di_r[hh]);
          dg[hh] = fmaf(d, bv[i], dg[hh]);
          ds[e] = d * scale;
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

  // dgate: the quad's four partials of each row, in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = dg[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((tid & 3) == 0 && row_ok[hh]) dgate[srow + row_r[hh]] = sum;
  }
  store_rows(acc_dq, dq + obase, kWgD, q0, L, tid);
}

// dbias for one 64 x 64 tile (q rows, KV columns) of one head, summed over
// the batch rows in order; blockIdx = (KV tile, q tile, h).  Reads the di
// of wavlm_bwd_dq_wgmma_kernel; arguments as there.
__global__ void __launch_bounds__(kWgThreads)
    wavlm_bwd_dbias_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ gate, const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ m_in, const float* __restrict__ l_in,
        const float* __restrict__ di_in, float* __restrict__ dbias,
        const int* __restrict__ lengths, int B, int H, int L, Strides in,
        float scale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sbase = wg_smem + (base - raw);

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * kWgRows;
  const int q0 = blockIdx.y * kWgRows;
  const int h = blockIdx.z;

  // batch row b's Q, dO, K, V tiles and the q rows' m, l, di and gate into
  // ring stage st (statistics by threads 0-63: m, di; 64-127: l, gate; rows
  // past L read as 0)
  auto load = [&](int st, int b) {
    const uint32_t dst = base + st * kWlStage;
    const long long ibase = (long long)b * in.batch + (long long)h * in.head;
    const long long srow = ((long long)b * H + h) * L;
    load_tile_async(dst, q + ibase, in.row, q0, L, tid);
    load_tile_async(dst + kWgTile, dout + srow * kWgD, kWgD, q0, L, tid);
    load_tile_async(dst + 2 * kWgTile, k + ibase, in.row, kv0, L, tid);
    load_tile_async(dst + 3 * kWgTile, v + ibase, in.row, kv0, L, tid);
    const int r = tid & 63, row = q0 + r;
    const bool ok = row < L;
    const long long idx = srow + (ok ? row : 0);
    const uint32_t sd = dst + 4 * kWgTile + 4 * r;
    if (tid < 64) {
      cp_async4(sd, m_in + idx, ok);
      cp_async4(sd + 8 * kWgRows, di_in + idx, ok);
    } else {
      cp_async4(sd + 4 * kWgRows, l_in + idx, ok);
      cp_async4(sd + 12 * kWgRows, gate + idx, ok);
    }
  };
  load(0, 0);
  cp_async_commit();

  // this thread's two q rows and its bias entries, the same for every
  // batch row
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int cpair = 2 * (tid & 3);
  int row_r[2];
  float bv[32];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_r[hh] = q0 + r_lo + 8 * hh;
    const float* brow = bias + ((long long)h * L + min(row_r[hh], L - 1)) * L;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + 8 * j + cpair + e;
        bv[4 * j + 2 * hh + e] = row_r[hh] < L && col < L ? __ldg(brow + col) : 0.f;
      }
  }

  float acc[32], s[32], dp[32];
  zero(acc);
  zero(s);
  zero(dp);
  for (int b = 0; b < B; ++b) {
    if (b + 1 < B) load((b + 1) & 1, b + 1);  // stage (b + 1) % 2 was released at b - 1
    cp_async_commit();
    cp_async_wait<1>();  // batch row b has landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t st = base + (b & 1) * kWlStage;
    const float* stat = reinterpret_cast<const float*>(sbase + (b & 1) * kWlStage + 4 * kWgTile);
    const uint64_t dQ = desc_k_major(st), ddO = desc_k_major(st + kWgTile);
    const uint64_t dK = desc_k_major(st + 2 * kWgTile), dV = desc_k_major(st + 3 * kWgTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dQ + 2 * kk, dK + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, ddO + 2 * kk, dV + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    const int len = valid_len(lengths, b, L);
    const bool dropout = drop.seed != nullptr;
    const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;
    float m_r[2], li_r[2], di_r[2], g_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r_lo + 8 * hh;
      const float l = stat[kWgRows + r];
      m_r[hh] = stat[r];
      li_r[hh] = row_r[hh] < L ? (l == 0.f ? 1.f : 1.f / l) : 0.f;
      di_r[hh] = stat[2 * kWgRows + r];
      g_r[hh] = stat[3 * kWgRows + r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const int col = kv0 + 8 * j + cpair + e;
          const float x = col < len ? fmaf(g_r[hh], bv[i], s[i] * scale) : kNegInf;
          const float p = col < L ? exp2f((x - m_r[hh]) * kLog2e) * li_r[hh] : 0.f;
          float dpv = dp[i];
          if (dropout)
            dpv = dropout_keep(bh_seed, (unsigned)row_r[hh], (unsigned)col, drop.threshold)
                      ? dpv * drop.inv_keep : 0.f;
          acc[i] = fmaf(g_r[hh], p * (dpv - di_r[hh]), acc[i]);
        }
    __syncthreads();  // every thread is done with stage b % 2
  }
  cp_async_wait<0>();

  // scalar stores: the rows of dbias are only 4-byte aligned
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row_r[hh] >= L) continue;
    float* dst = dbias + ((long long)h * L + row_r[hh]) * L;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + 8 * j + cpair + e;
        if (col < L) dst[col] = acc[4 * j + 2 * hh + e];
      }
  }
}

// dk and dv for one (64-row KV tile, head, batch row); blockIdx = (b, KV
// tile, h).  Reads the di of wavlm_bwd_dq_wgmma_kernel; dk, dv contiguous
// (B, H, L, 64); other arguments as there.
__global__ void __launch_bounds__(kWgThreads, kWlBlocksPerSm)
    wavlm_bwd_dkv_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ gate, const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ m_in, const float* __restrict__ l_in,
        const float* __restrict__ di_in, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, const int* __restrict__ lengths, int H,
        int L, Strides in, float scale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + kWgTile;
  const uint32_t ring = base + 2 * kWgTile;  // stage s: Q at ring + 2 s kWgTile, dO after it
  const uint32_t stat_addr = base + 2 * kWgTile + kWgRing;  // stage s at + s kWlStats
  const float* stats = reinterpret_cast<const float*>(wg_smem + (stat_addr - raw));
  const uint32_t bias_addr = stat_addr + kWgStages * kWlStats;
  const float* sbias = reinterpret_cast<const float*>(wg_smem + (bias_addr - raw));

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int kv0 = blockIdx.y * kWgRows;
  const int h = blockIdx.z;

  const int len = valid_len(lengths, b, L);
  const int kv_end = len > 0 ? len : L;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long ibase = (long long)b * in.batch + (long long)h * in.head;
  const long long sbase = ((long long)b * H + h) * L;
  const long long obase = sbase * kWgD;
  const __nv_bfloat16* qb = q + ibase;
  const __nv_bfloat16* ob = dout + obase;

  // m and di by threads 0-63, l and gate by threads 64-127, one row each;
  // rows past L read as 0 (their Q and dO rows are 0 as well, and 1/l is
  // set to 0)
  auto load_stats = [&](uint32_t dst, int q0) {
    const int r = tid & 63, row = q0 + r;
    const bool ok = row < L;
    const long long idx = sbase + (ok ? row : 0);
    if (tid < 64) {
      cp_async4(dst + 4 * r, m_in + idx, ok);
      cp_async4(dst + 8 * kWgRows + 4 * r, di_in + idx, ok);
    } else {
      cp_async4(dst + 4 * kWgRows + 4 * r, l_in + idx, ok);
      cp_async4(dst + 12 * kWgRows + 4 * r, gate + idx, ok);
    }
  };

  // the bias tile of q rows q0 .. q0 + 63 and this block's KV columns, row
  // by row (coalesced); entries past L read as 0
  auto load_bias = [&](int q0) {
    const float* bh = bias + (long long)h * L * L;
#pragma unroll 4
    for (int i = tid; i < kWgRows * kWgRows; i += kWgThreads) {
      const int r = i >> 6, c = i & 63, row = q0 + r, col = kv0 + c;
      const bool ok = row < L && col < L;
      cp_async4(bias_addr + 4 * (r * kWlBiasStride + c),
                bh + (ok ? (long long)row * L + col : 0LL), ok);
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
    load_tile_async(ring + kWgTile, ob, kWgD, 0, L, tid);
    load_stats(stat_addr, 0);
    load_bias(0);
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
        load_tile_async(next + kWgTile, ob, kWgD, (t + 1) * kWgRows, L, tid);
        load_stats(stat_addr + nxt * kWlStats, (t + 1) * kWgRows);
      }
      cp_async_commit();
      cp_async_wait<1>();  // tile t and its bias tile have landed
      fence_proxy_async();
      __syncthreads();

      const uint32_t sQ = ring + (t & 1) * 2 * kWgTile, sdO = sQ + kWgTile;
      const float* st = stats + (t & 1) * (kWlStats / 4);
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
      // the columns are this q tile's rows, and the bias term joins S^T
      // here (the staged tile read transposed)
      const int q0 = t * kWgRows;
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 8 * j + cpair;
        const float2 m2 = *reinterpret_cast<const float2*>(st + r);
        const float2 l2 = *reinterpret_cast<const float2*>(st + kWgRows + r);
        const float2 di2 = *reinterpret_cast<const float2*>(st + 2 * kWgRows + r);
        const float2 g2 = *reinterpret_cast<const float2*>(st + 3 * kWgRows + r);
        const float mv[2] = {m2.x, m2.y}, lv[2] = {l2.x, l2.y}, dv_[2] = {di2.x, di2.y};
        const float gv[2] = {g2.x, g2.y};
        bool ok[2];
        float li[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ok[e] = q0 + r + e < L;
          li[e] = ok[e] ? (lv[e] == 0.f ? 1.f : 1.f / lv[e]) : 0.f;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pu[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const unsigned row = q0 + r + e;
            const float bv = sbias[(r + e) * kWlBiasStride + c_lo + 8 * hh];
            const float x = valid_r[hh] ? fmaf(gv[e], bv, s[i] * scale) : kNegInf;
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

      // every thread has read the bias tile: the next q tile's takes its
      // place while dV and dK multiply (landing with the ring's next stage)
      __syncthreads();
      if (t + 1 < n_q) load_bias((t + 1) * kWgRows);
      cp_async_commit();

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

  store_rows(acc_dk, dk + obase, kWgD, kv0, L, tid);
  store_rows(acc_dv, dv + obase, kWgD, kv0, L, tid);
}

}  // namespace
