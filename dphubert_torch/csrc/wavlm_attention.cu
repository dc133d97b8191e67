// WavLM attention for Hopper (sm_90a): attention whose scores carry the gated
// relative-position bias, kept factored,
//   s[b,h,i,j] = scale * q_i . k_j + gate[b,h,i] * bias[h,i,j],
// key columns j >= lengths[b] masked, with attention-probability dropout;
// forward and backward.  bias (H, L, L) is shared across the batch and
// gate (B, H, L) is one value per query row, both fp32: nothing of size
// B*H*L*L is ever in memory.
//
// Replaces the seven Pallas kernels of the TPU package's
// ops/wavlm_attention.py with three kernel bodies:
//   * wavlm_fwd_kernel: _fwd_single_kernel (pallas_call at :216), entry
//     wavlm_attention_fwd, and _fwd_kernel (:268), entry
//     wavlm_attention_fwd_general.  out, and the row max m and undropped
//     row sum l for the backward;
//   * wavlm_dkv_kernel: _bwd_dkv_single_kernel (:642), entry
//     wavlm_attention_bwd_dkv, and _bwd_dkv_kernel (:766), entry
//     wavlm_attention_bwd_dkv_general.  dk and dv;
//   * wavlm_bwd_q_kernel: _bwd_fused_single_kernel (:679), entry
//     wavlm_attention_bwd_fused (dq, dgate and dbias in one pass);
//     _bwd_dq_kernel (:805), entry wavlm_attention_bwd_dq (dq and dgate:
//     the same body with the dbias strip switched off); and
//     _bwd_dbias_kernel (:844), entry wavlm_attention_bwd_dbias (the body
//     with dq and dgate switched off, one KV tile per block).
// The TPU's single-KV-block and general kernels compute the same functions
// with another grid order (one KV block holds the whole row there, so the
// single forward needs no online softmax and the single backward fuses
// dbias into the dq pass).  Here every body walks the keys in 64-wide
// tiles with an online softmax either way; the two entries of a pair differ
// in the order of their blocks (the single entries put the batch index
// innermost, so the B blocks that read one bias tile run together and share
// it in L2, as the TPU kernels kept it in VMEM across an inner batch axis)
// and, for the backward, in where dbias is summed.
//
// Semantics (as the Pallas kernels, in fp32 whatever the input type):
//   s = (q . k) * scale + gate * bias; key column c of batch b is masked
//   with the finite NEG_INF when c >= min(lengths[b], L); the kernels mask
//   the ragged edge past L themselves (the TPU wrapper padded to Lp with a
//   zero bias and masked the padding; the outputs of valid rows are the
//   same);
//   forward: p = exp(s - m) rounded to the input type before the PV
//   product, zeroed where the dropout hash drops it; l is the undropped sum;
//   out = acc / l / (1 - rate), 1/l taken as 1 when l == 0;
//   backward: p = exp(s - m) / l recomputed; dp = dout . v^T, dropped and
//   scaled by 1/(1 - rate); di = rowsum(out * dout); ds = p * (dp - di);
//   dq = scale * ds . k, dk = scale * ds^T . q, dv = p~^T . dout (p~ the
//   dropped, scaled p); dgate[b,h,i] = sum_j ds * bias and dbias[h,i,j] =
//   sum_b gate * ds, both from the unscaled ds.
// The dropout hash (attention_common.cuh) is the packed and flash kernels':
// h is the index within the tensors' heads (the selected heads), rows and
// columns are absolute, so the mask equals theirs bit for bit.
//
// What bounds it on an H100: per (query, valid key, head) the forward does
// 4*D operations and the backward 14*D (dkv 8*D, the dq side 6*D), against
// reads of q, k, v, dout of the same order as HuBERT's and of the (H, L, L)
// bias table: at the stage-1 shape (B = 16, L = 749, 12 heads of 64) the
// operations outweigh the bytes, so the kernels are bound by operations.
// Like the packed and flash kernels, this first version runs fp32 FMA on the
// CUDA cores (67 TFLOP/s, not the tensor cores' 989 TFLOP/s in bf16).  What
// the design does:
//   * the forward and dkv bodies are the flash bodies of attention_fwd.cu /
//     attention_bwd.cu (64x64 score tiles, a 4x4 register tile a thread)
//     with the bias term added where the scores are formed; the forward
//     reads the bias straight from device memory in its epilogue (two rows
//     of 16 consecutive floats a warp), the dkv body stages the 64x64 bias
//     tile, transposed, in the shared-memory tile that then receives dS, so
//     the bias costs it no shared memory of its own;
//   * the dq side takes one block per (head, 32-row q tile) and loops over
//     the batch inside, over the KV tiles inside that: dq and the dgate
//     partial sums stay in registers and are written after each batch row,
//     and the (32 x L) fp32 dbias strip stays in shared memory and is
//     written once after the last batch row.  No float atomics: every sum
//     has one owner and a fixed order, so two runs give the same bits;
//   * the general dq entry is the same body with the strip off and one
//     block per (q tile, head, batch row); the general dbias entry one
//     block per (q tile, head, KV tile) looping over the batch;
//   * KV tiles wholly past lengths[b] are skipped (p = 0 there).
// Limit: the fused entry's strip needs 128 * ceil64(L) bytes of shared
// memory beside its tiles; past L = 1344 frames (D = 64; 1216 for D = 80)
// it does not fit, the entry returns cudaErrorInvalidValue, and the
// wrapper refuses such a call before it launches (the stage-1 step runs at
// L <= 780).
#include "attention_common.cuh"

namespace {

constexpr int kRowsQ = 32;    // q rows of the backward's dq-side body
constexpr int kStripPad = 8;  // rows 2 apart of the strip land 16 banks apart

// Where a block's (tile, head, batch) indices come from: the single
// entries put the batch innermost (blockIdx.x), the general ones outermost.
struct Tile {
  int tile, h, b;
};
__device__ __forceinline__ Tile block_tile(bool batch_inner) {
  if (batch_inner) return Tile{(int)blockIdx.y, (int)blockIdx.z, (int)blockIdx.x};
  return Tile{(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
}
dim3 tile_grid(int tiles, int H, int B, bool batch_inner) {
  return batch_inner ? dim3(B, tiles, H) : dim3(tiles, H, B);
}

struct WArgs {
  const void *q, *k, *v, *out, *dout;
  const float *bias, *gate;
  float *m, *l, *di, *dgate, *dbias;
  void *o, *dq, *dk, *dv;
  const int* lengths;
  int B, H, L;
  Strides in;  // q, k, v: (batch, row, head) element strides
  float scale;
  Dropout drop;
  bool batch_inner;
};

// Rows r0 .. r0+rows-1 of a (row, D) slice into a padded fp32 tile; rows
// past L read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows, int L) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < L ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ int valid_len(const int* lengths, int b, int L) {
  return lengths != nullptr ? max(0, min(lengths[b], L)) : L;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int fwd_smem_floats(int d) {
  return kBlockQ * (d + 1) + kBlockKV * (d + 1) + kBlockKV * d +
         kBlockQ * kPStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    wavlm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ gate, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     const int* __restrict__ lengths, int H, int L, Strides in,
                     float scale, Dropout drop, bool batch_inner) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KP = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                   // kBlockQ x KP
  float* sK = sQ + kBlockQ * KP;      // kBlockKV x KP
  float* sV = sK + kBlockKV * KP;     // kBlockKV x D
  float* sP = sV + kBlockKV * D;      // kBlockQ x kPStride

  const Tile t = block_tile(batch_inner);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // kv columns tx + 16 j
  const int ty = tid >> 4;  // q rows 4 ty .. 4 ty + 3
  const int q0 = t.tile * kBlockQ, h = t.h, b = t.b;

  const int len = valid_len(lengths, b, L);
  const int kv_end = len > 0 ? len : L;  // a row with no valid key averages all
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const long long srow = ((long long)b * H + h) * L;  // gate, m, l of (b, h)
  const float* bias_h = bias + (long long)h * L * L;
  load_rows<T, D>(sQ, q + base, in.row, q0, kBlockQ, L);

  float m[4], l[4], g[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    g[i] = row < L ? gate[srow + row] : 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    for (int i = tid; i < kBlockKV * D; i += kThreads) {
      const int r = i / D, c = i % D, row = kv0 + r;
      const bool ok = row < L;
      sK[r * KP + c] = ok ? to_float(k[base + row * in.row + c]) : 0.f;
      sV[r * D + c] = ok ? to_float(v[base + row * in.row + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * KP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        // columns past L do not exist (excluded); columns past the length
        // are masked with the finite NEG_INF, as in the Pallas kernels
        const float bv = (row < L && col < L) ? bias_h[(long long)row * L + col] : 0.f;
        float x = s[i][j] * scale + g[i] * bv;
        x = col < len ? x : kNegInf;
        x = col < L ? x : -CUDART_INF_F;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_next = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_next);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned col = kv0 + tx + 16 * j;
        const float p = expf(s[i][j] - m_next);
        row_sum += p;  // l is the undropped sum
        float kept = round_to<T>(p);
        if (dropout && !dropout_keep(bh_seed, (unsigned)row, col, drop.threshold))
          kept = 0.f;
        sP[(4 * ty + i) * kPStride + tx + 16 * j] = kept;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_next;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockKV; ++j) {
      float vv[DPT];
#pragma unroll
      for (int d = 0; d < DPT; ++d) vv[d] = sV[j * D + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(4 * ty + i) * kPStride + j];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

  // out, m, l: contiguous (B, H, L, D) and (B, H, L)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
    const float l_inv = (l[i] == 0.f ? 1.f : 1.f / l[i]) * drop.inv_keep;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      out[(srow + row) * D + tx + 16 * d] = from_float<T>(acc[i][d] * l_inv);
    if (tx == 0) {
      m_out[srow + row] = m[i];
      l_out[srow + row] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (64-row KV tile, head, batch row), looping over the
// q tiles with dK and dV in registers
// ---------------------------------------------------------------------------

constexpr int kStats = 4 * kBlockQ;  // m, 1/l, di and gate of the q rows

constexpr int dkv_smem_floats(int d) {
  return 4 * kBlockQ * (d + 1) + 2 * kBlockKV * kPStride + kStats;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    wavlm_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ gate, const T* __restrict__ dout,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ di_in, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ lengths,
                     int H, int L, Strides in, float scale, Dropout drop,
                     bool batch_inner) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KP = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // the block's kv rows x KP, resident
  float* sV = sK + kBlockKV * KP;    // the block's kv rows x KP, resident
  float* sQ = sV + kBlockKV * KP;    // q rows x KP
  float* sdO = sQ + kBlockQ * KP;    // q rows x KP
  float* sP = sdO + kBlockQ * KP;    // P~^T: kv rows x kPStride
  float* sS = sP + kBlockKV * kPStride;  // bias^T, then dS^T: kv rows x kPStride
  float* sM = sS + kBlockKV * kPStride;
  float* sLinv = sM + kBlockQ;
  float* sDi = sLinv + kBlockQ;
  float* sG = sDi + kBlockQ;

  const Tile t = block_tile(batch_inner);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q rows tx + 16 i; dk/dv columns tx + 16 d
  const int ty = tid >> 4;  // kv rows 4 ty .. 4 ty + 3
  const int kv0 = t.tile * kBlockKV, h = t.h, b = t.b;

  const int len = valid_len(lengths, b, L);
  const int kv_end = len > 0 ? len : L;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const long long srow = ((long long)b * H + h) * L;
  const float* bias_h = bias + (long long)h * L * L;

  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc_k[j][d] = acc_v[j][d] = 0.f;

  // a tile wholly past the valid keys has p = 0 in every row: zeros
  if (kv0 < kv_end) {
    load_rows<T, D>(sK, k + base, in.row, kv0, kBlockKV, L);
    load_rows<T, D>(sV, v + base, in.row, kv0, kBlockKV, L);
    for (int q0 = 0; q0 < L; q0 += kBlockQ) {
      __syncthreads();  // the previous q tile's sQ, sdO, sP, sS are consumed
      load_rows<T, D>(sQ, q + base, in.row, q0, kBlockQ, L);
      load_rows<T, D>(sdO, dout + srow * D, D, q0, kBlockQ, L);
      // the 64x64 bias tile, transposed: coalesced along the kv columns
      for (int i = tid; i < kBlockQ * kBlockKV; i += kThreads) {
        const int r = i / kBlockKV, c = i % kBlockKV;
        const int row = q0 + r, col = kv0 + c;
        sS[c * kPStride + r] =
            (row < L && col < L) ? bias_h[(long long)row * L + col] : 0.f;
      }
      if (tid < kBlockQ) {
        const int row = q0 + tid;
        const bool ok = row < L;
        const float l = ok ? l_in[srow + row] : 0.f;
        sM[tid] = ok ? m_in[srow + row] : 0.f;
        sLinv[tid] = ok ? (l == 0.f ? 1.f : 1.f / l) : 0.f;  // rows past L: p = 0
        sDi[tid] = ok ? di_in[srow + row] : 0.f;
        sG[tid] = ok ? gate[srow + row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // [kv row j][q row i]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sK[(4 * ty + j) * KP + d];
          vv[j] = sV[(4 * ty + j) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = sQ[(tx + 16 * i) * KP + d];
          ov[i] = sdO[(tx + 16 * i) * KP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
            dp[j][i] = fmaf(vv[j], ov[i], dp[j][i]);
          }
      }

      // each thread reads the bias entries it then overwrites with dS
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * ty + j;
        const int col = kv0 + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tx + 16 * i;
          const unsigned row = q0 + r;
          const float bv = sS[c * kPStride + r];
          const float x = col < len ? s[j][i] * scale + sG[r] * bv : kNegInf;
          const float p = col < L ? expf(x - sM[r]) * sLinv[r] : 0.f;
          float p_used = p, dpv = dp[j][i];
          if (dropout) {
            const bool keep = dropout_keep(bh_seed, row, col, drop.threshold);
            p_used = keep ? p * drop.inv_keep : 0.f;
            dpv = keep ? dpv * drop.inv_keep : 0.f;
          }
          sP[c * kPStride + r] = p_used;
          sS[c * kPStride + r] = p * (dpv - sDi[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < kBlockQ; ++i) {
        float ov[DPT], qv[DPT];
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          ov[d] = sdO[i * KP + tx + 16 * d];
          qv[d] = sQ[i * KP + tx + 16 * d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pv = sP[(4 * ty + j) * kPStride + i];
          const float dsv = sS[(4 * ty + j) * kPStride + i];
#pragma unroll
          for (int d = 0; d < DPT; ++d) {
            acc_v[j][d] = fmaf(pv, ov[d], acc_v[j][d]);
            acc_k[j][d] = fmaf(dsv, qv[d], acc_k[j][d]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = kv0 + 4 * ty + j;
    if (row >= L) continue;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dk[(srow + row) * D + tx + 16 * d] = from_float<T>(acc_k[j][d]);
      dv[(srow + row) * D + tx + 16 * d] = from_float<T>(acc_v[j][d]);
    }
  }
}

// ---------------------------------------------------------------------------
// The dq side: dq and dgate (kDq) and the dbias strip (kDbias), one block per
// (32-row q tile, head) and a range of batch rows and KV tiles:
//   fused (kDq, kDbias): every batch row, every KV tile, strip ceil64(L) wide;
//   dq    (kDq):         the batch row blockIdx.z, every KV tile, no strip;
//   dbias (kDbias):      every batch row, the KV tile blockIdx.z, strip 64 wide.
// ---------------------------------------------------------------------------

constexpr int q_smem_floats(int d) {
  return 2 * kRowsQ * (d + 1) + 2 * kBlockKV * (d + 1) + kRowsQ * kPStride +
         4 * kRowsQ;
}

template <typename T, int D, bool kDq, bool kDbias>
__global__ void __launch_bounds__(kThreads)
    wavlm_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ gate, const T* __restrict__ out,
                       const T* __restrict__ dout,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       float* __restrict__ di_out, T* __restrict__ dq,
                       float* __restrict__ dgate, float* __restrict__ dbias,
                       const int* __restrict__ lengths, int B, int H, int L,
                       Strides in, float scale, Dropout drop,
                       int strip_width) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(kDq || kDbias, "the body computes dq or dbias");
  constexpr int KP = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                    // q rows x KP
  float* sdO = sQ + kRowsQ * KP;       // q rows x KP
  float* sK = sdO + kRowsQ * KP;       // kv rows x KP
  float* sV = sK + kBlockKV * KP;      // kv rows x KP
  float* sDS = sV + kBlockKV * KP;     // q rows x kPStride: scale * dS
  float* sM = sDS + kRowsQ * kPStride;
  float* sLinv = sM + kRowsQ;
  float* sDi = sLinv + kRowsQ;
  float* sG = sDi + kRowsQ;
  float* sStrip = sG + kRowsQ;         // q rows x (strip_width + kStripPad)
  const int SS = strip_width + kStripPad;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // kv columns tx + 16 j; dq columns tx + 16 d
  const int ty = tid >> 4;  // q rows 2 ty, 2 ty + 1
  const int q0 = blockIdx.x * kRowsQ;
  const int h = blockIdx.y;
  int b_begin = 0, b_end = B, kv_begin = 0, kv_stop = L;
  if (!kDbias) {  // general dq: one batch row per block
    b_begin = blockIdx.z;
    b_end = b_begin + 1;
  }
  if (!kDq) {  // general dbias: one KV tile per block
    kv_begin = blockIdx.z * kBlockKV;
    kv_stop = min(L, kv_begin + kBlockKV);
  }
  const float* bias_h = bias + (long long)h * L * L;

  if (kDbias)
    for (int i = tid; i < kRowsQ * SS; i += kThreads) sStrip[i] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    const int len = valid_len(lengths, b, L);
    const int kv_end = min(kv_stop, len > 0 ? len : L);
    const bool dropout = drop.seed != nullptr;
    const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;
    const long long base = (long long)b * in.batch + (long long)h * in.head;
    const long long srow = ((long long)b * H + h) * L;

    __syncthreads();  // the previous batch row's tiles and statistics are consumed
    load_rows<T, D>(sQ, q + base, in.row, q0, kRowsQ, L);
    load_rows<T, D>(sdO, dout + srow * D, D, q0, kRowsQ, L);
    __syncthreads();

    // di = rowsum(out * dout), m, 1/l and the gate of the tile's rows, 8
    // threads a row; rows past L get p = 0 through 1/l = 0
    {
      const int r = tid >> 3, part = tid & 7, row = q0 + r;
      float acc = 0.f;
      if (row < L)
        for (int c = part; c < D; c += 8)
          acc = fmaf(to_float(out[(srow + row) * D + c]), sdO[r * KP + c], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (part == 0) {
        float m = 0.f, l_inv = 0.f, g = 0.f;
        if (row < L) {
          if (di_out != nullptr) di_out[srow + row] = acc;
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

    float acc[2][DPT], dg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dg[i] = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
    }

    for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
      __syncthreads();  // the previous tile's sK, sV and sDS are consumed
      load_rows<T, D>(sK, k + base, in.row, kv0, kBlockKV, L);
      load_rows<T, D>(sV, v + base, in.row, kv0, kBlockKV, L);
      __syncthreads();

      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[2], ov[2], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          qv[i] = sQ[(2 * ty + i) * KP + d];
          ov[i] = sdO[(2 * ty + i) * KP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sK[(tx + 16 * j) * KP + d];
          vv[j] = sV[(tx + 16 * j) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int col = kv0 + c;
          const float bv = (row < L && col < L) ? bias_h[(long long)row * L + col] : 0.f;
          const float x = col < len ? s[i][j] * scale + sG[r] * bv : kNegInf;
          const float p = col < L ? expf(x - sM[r]) * sLinv[r] : 0.f;
          float dpv = dp[i][j];
          if (dropout)
            dpv = dropout_keep(bh_seed, (unsigned)row, (unsigned)col, drop.threshold)
                      ? dpv * drop.inv_keep : 0.f;
          const float ds = p * (dpv - sDi[r]);
          if (kDq) {
            dg[i] = fmaf(ds, bv, dg[i]);
            sDS[r * kPStride + c] = ds * scale;
          }
          // one owner per strip entry: the thread of (row, column)
          if (kDbias) sStrip[r * SS + col - kv_begin] += sG[r] * ds;
        }
      }

      if (kDq) {
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kBlockKV; ++j) {
          float kv[DPT];
#pragma unroll
          for (int d = 0; d < DPT; ++d) kv[d] = sK[j * KP + tx + 16 * d];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float ds = sDS[(2 * ty + i) * kPStride + j];
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(ds, kv[d], acc[i][d]);
          }
        }
      }
    }

    if (kDq) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float sum = dg[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const int row = q0 + 2 * ty + i;
        if (row >= L) continue;
        if (tx == 0) dgate[srow + row] = sum;
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          dq[(srow + row) * D + tx + 16 * d] = from_float<T>(acc[i][d]);
      }
    }
  }

  if (kDbias) {
    __syncthreads();
    const int width = min(strip_width, L - kv_begin);
    for (int i = tid; i < kRowsQ * strip_width; i += kThreads) {
      const int r = i / strip_width, c = i % strip_width, row = q0 + r;
      if (row < L && c < width)
        dbias[((long long)h * L + row) * L + kv_begin + c] = sStrip[r * SS + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

cudaError_t smem_limit(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)optin;
  return err;
}

template <typename T, int D>
cudaError_t launch_fwd(const WArgs& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * fwd_smem_floats(D);
  auto kernel = wavlm_fwd_kernel<T, D>;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  const int tiles = (a.L + kBlockQ - 1) / kBlockQ;
  kernel<<<tile_grid(tiles, a.H, a.B, a.batch_inner), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, a.gate, static_cast<T*>(a.o), a.m,
      a.l, a.lengths, a.H, a.L, a.in, a.scale, a.drop, a.batch_inner);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const WArgs& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dkv_smem_floats(D);
  auto kernel = wavlm_dkv_kernel<T, D>;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  const int tiles = (a.L + kBlockKV - 1) / kBlockKV;
  kernel<<<tile_grid(tiles, a.H, a.B, a.batch_inner), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, a.gate,
      static_cast<const T*>(a.dout), a.m, a.l, a.di, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.lengths, a.H, a.L, a.in, a.scale, a.drop,
      a.batch_inner);
  return cudaGetLastError();
}

template <typename T, int D, bool kDq, bool kDbias>
cudaError_t launch_q(const WArgs& a, cudaStream_t stream) {
  const int kv_tiles = (a.L + kBlockKV - 1) / kBlockKV;
  const int strip_width = kDbias ? (kDq ? kv_tiles * kBlockKV : kBlockKV) : 0;
  const size_t smem =
      sizeof(float) * (q_smem_floats(D) +
                       (kDbias ? kRowsQ * (strip_width + kStripPad) : 0));
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;  // the fused strip is too wide
  auto kernel = wavlm_bwd_q_kernel<T, D, kDq, kDbias>;
  static bool configured = false;  // opt into the largest size once
  err = allow_smem(kernel, limit, &configured);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.L + kRowsQ - 1) / kRowsQ;
  const int z = kDbias ? (kDq ? 1 : kv_tiles) : a.B;
  kernel<<<dim3(q_tiles, a.H, z), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, a.gate,
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.m, a.l,
      a.di, static_cast<T*>(a.dq), a.dgate, a.dbias, a.lengths, a.B, a.H, a.L,
      a.in, a.scale, a.drop, strip_width);
  return cudaGetLastError();
}

enum class Kind { kFwd, kDkv, kFused, kDq, kDbias };

template <typename T, int D>
cudaError_t launch(Kind kind, const WArgs& a, cudaStream_t stream) {
  switch (kind) {
    case Kind::kFwd: return launch_fwd<T, D>(a, stream);
    case Kind::kDkv: return launch_dkv<T, D>(a, stream);
    case Kind::kFused: return launch_q<T, D, true, true>(a, stream);
    case Kind::kDq: return launch_q<T, D, true, false>(a, stream);
    case Kind::kDbias: return launch_q<T, D, false, true>(a, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Kind kind, int dtype, int D, const WArgs& a,
                     cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.L <= 0) return cudaErrorInvalidValue;
  // 64: Base and Large (768/12, 1024/16); 80: XLarge (1280/16)
  if (dtype == 0) {
    if (D == 64) return launch<float, 64>(kind, a, stream);
    if (D == 80) return launch<float, 80>(kind, a, stream);
  } else if (dtype == 1) {
    if (D == 64) return launch<__nv_bfloat16, 64>(kind, a, stream);
    if (D == 80) return launch<__nv_bfloat16, 80>(kind, a, stream);
  }
  return cudaErrorInvalidValue;
}

WArgs make_args(const void* q, const void* k, const void* v, const void* bias,
                const void* gate, const void* lengths, const void* seed,
                unsigned threshold, float inv_keep, int B, int H, int L,
                long long stride_batch, long long stride_head,
                long long stride_row, float scale, bool batch_inner) {
  WArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.gate = static_cast<const float*>(gate);
  a.lengths = static_cast<const int*>(lengths);
  a.B = B; a.H = H; a.L = L;
  a.in = Strides{stride_batch, stride_row, stride_head};
  a.scale = scale;
  a.drop = Dropout{static_cast<const int*>(seed), threshold,
                   seed != nullptr ? inv_keep : 1.f};
  a.batch_inner = batch_inner;
  return a;
}

int fwd(bool batch_inner, const void* q, const void* k, const void* v,
        const void* bias, const void* gate, void* out, void* m, void* l,
        const void* lengths, const void* seed, unsigned threshold,
        float inv_keep, int B, int H, int L, int D, long long sb,
        long long sh, long long sr, float scale, int dtype, void* stream) {
  WArgs a = make_args(q, k, v, bias, gate, lengths, seed, threshold, inv_keep,
                      B, H, L, sb, sh, sr, scale, batch_inner);
  a.o = out;
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  return dispatch(Kind::kFwd, dtype, D, a, static_cast<cudaStream_t>(stream));
}

int dkv(bool batch_inner, const void* q, const void* k, const void* v,
        const void* bias, const void* gate, const void* dout, const void* m,
        const void* l, const void* di, void* dk, void* dv, const void* lengths,
        const void* seed, unsigned threshold, float inv_keep, int B, int H,
        int L, int D, long long sb, long long sh, long long sr, float scale,
        int dtype, void* stream) {
  WArgs a = make_args(q, k, v, bias, gate, lengths, seed, threshold, inv_keep,
                      B, H, L, sb, sh, sr, scale, batch_inner);
  a.dout = dout;
  a.m = const_cast<float*>(static_cast<const float*>(m));
  a.l = const_cast<float*>(static_cast<const float*>(l));
  a.di = const_cast<float*>(static_cast<const float*>(di));
  a.dk = dk;
  a.dv = dv;
  return dispatch(Kind::kDkv, dtype, D, a, static_cast<cudaStream_t>(stream));
}

int q_side(Kind kind, const void* q, const void* k, const void* v,
           const void* bias, const void* gate, const void* out,
           const void* dout, const void* m, const void* l, void* di, void* dq,
           void* dgate, void* dbias, const void* lengths, const void* seed,
           unsigned threshold, float inv_keep, int B, int H, int L, int D,
           long long sb, long long sh, long long sr, float scale, int dtype,
           void* stream) {
  WArgs a = make_args(q, k, v, bias, gate, lengths, seed, threshold, inv_keep,
                      B, H, L, sb, sh, sr, scale, false);
  a.out = out;
  a.dout = dout;
  a.m = const_cast<float*>(static_cast<const float*>(m));
  a.l = const_cast<float*>(static_cast<const float*>(l));
  a.di = static_cast<float*>(di);
  a.dq = dq;
  a.dgate = static_cast<float*>(dgate);
  a.dbias = static_cast<float*>(dbias);
  return dispatch(kind, dtype, D, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// q, k, v: (B, H, L, D) views with element strides (sb, sh, sr) and unit
// stride along D.  bias: contiguous (H, L, L) float32; gate: contiguous
// (B, H, L) float32.  out: contiguous (B, H, L, D); m, l: contiguous
// (B, H, L) float32.  lengths: (B,) int32 or null.  seed: one int32 on the
// card, or null for no dropout; threshold and inv_keep as in
// attention_common.cuh.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t.  The single entry orders its blocks batch-innermost.
int wavlm_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, const void* gate, void* out, void* m,
                        void* l, const void* lengths, const void* seed,
                        unsigned threshold, float inv_keep, int B, int H, int L,
                        int D, long long sb, long long sh, long long sr,
                        float scale, int dtype, void* stream) {
  return fwd(true, q, k, v, bias, gate, out, m, l, lengths, seed, threshold,
             inv_keep, B, H, L, D, sb, sh, sr, scale, dtype, stream);
}

// As wavlm_attention_fwd, blocks ordered batch-outermost.
int wavlm_attention_fwd_general(const void* q, const void* k, const void* v,
                                const void* bias, const void* gate, void* out,
                                void* m, void* l, const void* lengths,
                                const void* seed, unsigned threshold,
                                float inv_keep, int B, int H, int L, int D,
                                long long sb, long long sh, long long sr,
                                float scale, int dtype, void* stream) {
  return fwd(false, q, k, v, bias, gate, out, m, l, lengths, seed, threshold,
             inv_keep, B, H, L, D, sb, sh, sr, scale, dtype, stream);
}

// dk, dv: contiguous (B, H, L, D), from dout (contiguous (B, H, L, D)), the
// forward's m and l and the di a dq-side entry wrote ((B, H, L) float32).
// Other arguments as for wavlm_attention_fwd.
int wavlm_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* bias, const void* gate,
                            const void* dout, const void* m, const void* l,
                            const void* di, void* dk, void* dv,
                            const void* lengths, const void* seed,
                            unsigned threshold, float inv_keep, int B, int H,
                            int L, int D, long long sb, long long sh,
                            long long sr, float scale, int dtype,
                            void* stream) {
  return dkv(true, q, k, v, bias, gate, dout, m, l, di, dk, dv, lengths, seed,
             threshold, inv_keep, B, H, L, D, sb, sh, sr, scale, dtype, stream);
}

// As wavlm_attention_bwd_dkv, blocks ordered batch-outermost.
int wavlm_attention_bwd_dkv_general(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, const void* dout, const void* m, const void* l,
    const void* di, void* dk, void* dv, const void* lengths, const void* seed,
    unsigned threshold, float inv_keep, int B, int H, int L, int D,
    long long sb, long long sh, long long sr, float scale, int dtype,
    void* stream) {
  return dkv(false, q, k, v, bias, gate, dout, m, l, di, dk, dv, lengths, seed,
             threshold, inv_keep, B, H, L, D, sb, sh, sr, scale, dtype, stream);
}

// dq (contiguous (B, H, L, D)), dgate ((B, H, L) float32), dbias ((H, L, L)
// float32) and di ((B, H, L) float32, for wavlm_attention_bwd_dkv), from out
// and dout (contiguous (B, H, L, D)) and the forward's m and l.  Other
// arguments as for wavlm_attention_fwd.  cudaErrorInvalidValue when the
// dbias strip of 32 rows x ceil64(L) does not fit in shared memory.
int wavlm_attention_bwd_fused(const void* q, const void* k, const void* v,
                              const void* bias, const void* gate,
                              const void* out, const void* dout,
                              const void* m, const void* l, void* di, void* dq,
                              void* dgate, void* dbias, const void* lengths,
                              const void* seed, unsigned threshold,
                              float inv_keep, int B, int H, int L, int D,
                              long long sb, long long sh, long long sr,
                              float scale, int dtype, void* stream) {
  return q_side(Kind::kFused, q, k, v, bias, gate, out, dout, m, l, di, dq,
                dgate, dbias, lengths, seed, threshold, inv_keep, B, H, L, D,
                sb, sh, sr, scale, dtype, stream);
}

// As wavlm_attention_bwd_fused without dbias (pass null).
int wavlm_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* bias, const void* gate, const void* out,
                           const void* dout, const void* m, const void* l,
                           void* di, void* dq, void* dgate, void* dbias,
                           const void* lengths, const void* seed,
                           unsigned threshold, float inv_keep, int B, int H,
                           int L, int D, long long sb, long long sh,
                           long long sr, float scale, int dtype, void* stream) {
  return q_side(Kind::kDq, q, k, v, bias, gate, out, dout, m, l, di, dq, dgate,
                nullptr, lengths, seed, threshold, inv_keep, B, H, L, D, sb,
                sh, sr, scale, dtype, stream);
}

// As wavlm_attention_bwd_fused with dbias only (di, dq and dgate: pass
// null): one block per (q tile, head, KV tile), the batch summed inside.
int wavlm_attention_bwd_dbias(const void* q, const void* k, const void* v,
                              const void* bias, const void* gate,
                              const void* out, const void* dout,
                              const void* m, const void* l, void* di, void* dq,
                              void* dgate, void* dbias, const void* lengths,
                              const void* seed, unsigned threshold,
                              float inv_keep, int B, int H, int L, int D,
                              long long sb, long long sh, long long sr,
                              float scale, int dtype, void* stream) {
  return q_side(Kind::kDbias, q, k, v, bias, gate, out, dout, m, l, nullptr,
                nullptr, nullptr, dbias, lengths, seed, threshold, inv_keep, B,
                H, L, D, sb, sh, sr, scale, dtype, stream);
}

}  // extern "C"
