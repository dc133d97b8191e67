// Attention backward for Hopper (sm_90a): the gradients of
// out = dropout(softmax(scale * q k^T + key mask)) v.
//
// Replaces four Pallas kernels of the TPU package, two per layout:
//   * ops/packed_attention.py::_heads_loop_bwd_dq (pallas_call at :322) and
//     _heads_loop_bwd_dkv (:339), the packed (B, L, H*D) layout, entry points
//     packed_attention_bwd_dq and packed_attention_bwd_dkv;
//   * ops/flash_attention.py::_bwd_dq_kernel (pallas_call at :444) and
//     _bwd_dkv_kernel (:402), the (B, H, L, D) layout, entry points
//     flash_attention_bwd_dq and flash_attention_bwd_dkv.
// The two families compute the same function (_flash_bwd_rule :382-469 and
// _packed_bwd differ only in layout and tiling), so, as in attention_fwd.cu,
// one body per kernel serves both layouts through (batch, row, head)
// strides.  di = rowsum(out * dout) per head, which both TPU rules computed
// outside the kernels (flash_attention.py:390, packed :302-309), is fused
// into the dq kernel's prologue: dq writes di as (B, H, L) fp32 and dkv,
// launched after it on the same stream, reads it.  Both kernels regenerate
// the dropout mask from the hash in attention_common.cuh at absolute (b, h,
// row, col) and read the row statistics m and l that attention_fwd.cu
// stored, so neither p nor the mask is ever in memory.
//
// Semantics (as the Pallas kernels, in fp32 whatever the input type):
//   p  = exp(s - m) / l, the undropped softmax, s masked as in the forward;
//   dp = dout . v^T, dropped where the hash drops and scaled by 1/(1-rate);
//   ds = p * (dp - di) * scale;
//   dq = ds . k;   dk = ds^T . q;   dv = p~^T . dout, p~ the dropped p
//   scaled by 1/(1-rate).
// dkv is one block per KV tile looping over the q tiles (the TPU grid's
// sequential axis) with dK and dV in registers, and dq one block per q tile
// looping over the KV tiles up to lengths[b]: nothing is summed across
// blocks, so there are no atomics and a rerun gives the same bits.  KV tiles
// wholly past lengths[b] write zeros.
//
// What bounds it on an H100: dq does 6*D operations per (query, valid key,
// head) and dkv 8*D, against ~6 and ~8 (B, L, H*D) tensors of traffic, so
// both are bound by operations: at the stage-1 shape (16, 749, 12, 64) in
// bf16, 4.14e10 and 5.52e10 operations, 0.042 and 0.056 ms at the tensor
// cores' 989 TFLOP/s.  Two bodies per kernel, chosen at compile time by
// (dtype, D) in dispatch():
//   * bf16 at D = 64, every training step on the card (HuBERT Base's stage
//     1, the pruned students' final distill): the wgmma bodies of
//     attention_bwd_wgmma.cuh.  All four products of a tile pair run on the
//     tensor cores; Q, K, V and dO tiles sit in shared memory as bf16,
//     128-byte swizzled, the streamed ones in a cp.async ring; P~ and dS
//     stay in registers, rounded to bf16 as the A operand of the second
//     products (the one numerical difference from the CUDA-core body).
//   * fp32 (any D) and D = 80 (any dtype): the CUDA-core bodies below, fp32
//     FMA (67 TFLOP/s peak).  fp32 is the path of the card-vs-CPU step
//     checks, held to 1e-4 per kernel and 1e-3 per gradient, which TF32
//     (10-bit mantissa) products would break; no configuration trains at
//     D = 80 on the card (the XLarge preset is a factory only).  S and dP of
//     a 64x64 tile come out of one pass over D, each thread a 4x4 register
//     tile of both; dS (and dkv's P~^T) go through shared memory into the
//     gradient tile each thread keeps in registers.  Tiles are staged as
//     fp32, rows padded by one float so a warp's column reads hit distinct
//     banks.
#include "attention_common.cuh"
#include "attention_bwd_wgmma.cuh"

namespace {

constexpr int kStats = 3 * kBlockQ;  // m, 1/l and di of the tile's q rows

constexpr int dq_smem_floats(int d) {
  return 4 * kBlockQ * (d + 1) + kBlockQ * kPStride + kStats;
}
constexpr int dkv_smem_floats(int d) {
  return 4 * kBlockQ * (d + 1) + 2 * kBlockKV * kPStride + kStats;
}

// Loads rows r0 .. r0+63 of a (row, D) slice into a padded fp32 tile;
// rows past L read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int L) {
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < L ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ out,
                            const T* __restrict__ dout,
                            const float* __restrict__ m_in,
                            const float* __restrict__ l_in,
                            float* __restrict__ di_out, T* __restrict__ dq,
                            const int* __restrict__ lengths, int H, int L,
                            Strides in, Strides os, Strides gs, float scale,
                            Dropout drop) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KP = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // q rows x KP
  float* sdO = sQ + kBlockQ * KP;   // q rows x KP
  float* sK = sdO + kBlockQ * KP;   // kv rows x KP
  float* sV = sK + kBlockKV * KP;   // kv rows x KP
  float* sDS = sV + kBlockKV * KP;  // q rows x kPStride
  float* sM = sDS + kBlockQ * kPStride;
  float* sLinv = sM + kBlockQ;
  float* sDi = sLinv + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // kv columns tx + 16 j; dq columns tx + 16 d
  const int ty = tid >> 4;  // q rows 4 ty .. 4 ty + 3
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int len = L;
  if (lengths != nullptr) len = max(0, min(lengths[b], L));
  const int kv_end = len > 0 ? len : L;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const long long obase = (long long)b * os.batch + (long long)h * os.head;
  load_tile<T, D>(sQ, q + base, in.row, q0, L);
  load_tile<T, D>(sdO, dout + obase, os.row, q0, L);
  __syncthreads();

  // prologue: di = rowsum(out * dout) over the head, 4 threads per row;
  // rows past L get p = 0 through 1/l = 0
  {
    const int r = tid >> 2, part = tid & 3, row = q0 + r;
    float acc = 0.f;
    if (row < L)
      for (int c = part; c < D; c += 4)
        acc = fmaf(to_float(out[obase + row * os.row + c]), sdO[r * KP + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
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

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's sK and sDS are consumed
    load_tile<T, D>(sK, k + base, in.row, kv0, L);
    load_tile<T, D>(sV, v + base, in.row, kv0, L);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(4 * ty + i) * KP + d];
        ov[i] = sdO[(4 * ty + i) * KP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * KP + d];
        vv[j] = sV[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const unsigned row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        const float x = col < len ? s[i][j] * scale : kNegInf;
        const float p = col < L ? expf(x - sM[r]) * sLinv[r] : 0.f;
        float dpv = dp[i][j];
        if (dropout)
          dpv = dropout_keep(bh_seed, row, col, drop.threshold)
                    ? dpv * drop.inv_keep : 0.f;
        sDS[r * kPStride + tx + 16 * j] = p * (dpv - sDi[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockKV; ++j) {
      float kv[DPT];
#pragma unroll
      for (int d = 0; d < DPT; ++d) kv[d] = sK[j * KP + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sDS[(4 * ty + i) * kPStride + j];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(ds, kv[d], acc[i][d]);
      }
    }
  }

  const long long gbase = (long long)b * gs.batch + (long long)h * gs.head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      dq[gbase + row * gs.row + tx + 16 * d] = from_float<T>(acc[i][d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ m_in,
                             const float* __restrict__ l_in,
                             const float* __restrict__ di_in,
                             T* __restrict__ dk, T* __restrict__ dv,
                             const int* __restrict__ lengths, int H, int L,
                             Strides in, Strides os, Strides gs, float scale,
                             Dropout drop) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KP = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // the block's kv rows x KP, resident
  float* sV = sK + kBlockKV * KP;    // the block's kv rows x KP, resident
  float* sQ = sV + kBlockKV * KP;    // q rows x KP
  float* sdO = sQ + kBlockQ * KP;    // q rows x KP
  float* sP = sdO + kBlockQ * KP;    // P~^T: kv rows x kPStride
  float* sS = sP + kBlockKV * kPStride;  // dS^T: kv rows x kPStride
  float* sM = sS + kBlockKV * kPStride;
  float* sLinv = sM + kBlockQ;
  float* sDi = sLinv + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q rows tx + 16 i; dk/dv columns tx + 16 d
  const int ty = tid >> 4;  // kv rows 4 ty .. 4 ty + 3
  const int kv0 = blockIdx.x * kBlockKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int len = L;
  if (lengths != nullptr) len = max(0, min(lengths[b], L));
  const int kv_end = len > 0 ? len : L;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const long long obase = (long long)b * os.batch + (long long)h * os.head;
  const long long sbase = ((long long)b * H + h) * L;

  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc_k[j][d] = acc_v[j][d] = 0.f;

  // a tile wholly past the valid keys has p = 0 in every row: zeros
  if (kv0 < kv_end) {
    load_tile<T, D>(sK, k + base, in.row, kv0, L);
    load_tile<T, D>(sV, v + base, in.row, kv0, L);
    for (int q0 = 0; q0 < L; q0 += kBlockQ) {
      __syncthreads();  // the previous q tile's sQ, sdO, sP, sS are consumed
      load_tile<T, D>(sQ, q + base, in.row, q0, L);
      load_tile<T, D>(sdO, dout + obase, os.row, q0, L);
      if (tid < kBlockQ) {
        const int row = q0 + tid;
        const bool ok = row < L;
        const float l = ok ? l_in[sbase + row] : 0.f;
        sM[tid] = ok ? m_in[sbase + row] : 0.f;
        sLinv[tid] = ok ? (l == 0.f ? 1.f : 1.f / l) : 0.f;  // rows past L: p = 0
        sDi[tid] = ok ? di_in[sbase + row] : 0.f;
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

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * ty + j;
        const int col = kv0 + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tx + 16 * i;
          const unsigned row = q0 + r;
          const float x = col < len ? s[j][i] * scale : kNegInf;
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

  const long long gbase = (long long)b * gs.batch + (long long)h * gs.head;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = kv0 + 4 * ty + j;
    if (row >= L) continue;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dk[gbase + row * gs.row + tx + 16 * d] = from_float<T>(acc_k[j][d]);
      dv[gbase + row * gs.row + tx + 16 * d] = from_float<T>(acc_v[j][d]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float *m, *l;
  float* di;
  void *dq, *dk, *dv;
  const int* lengths;
  int B, H, L;
  Strides in, os, gs;
  float scale;
  Dropout drop;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dq_smem_floats(D);
  auto kernel = attention_bwd_dq_kernel<T, D>;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.m, a.l, a.di, static_cast<T*>(a.dq),
      a.lengths, a.H, a.L, a.in, a.os, a.gs, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dkv_smem_floats(D);
  auto kernel = attention_bwd_dkv_kernel<T, D>;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + kBlockKV - 1) / kBlockKV, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.m, a.l,
      a.di, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.lengths, a.H,
      a.L, a.in, a.os, a.gs, a.scale, a.drop);
  return cudaGetLastError();
}

cudaError_t launch_dq_wgmma(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = attention_bwd_dq_wgmma_kernel;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, kWgDqSmem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + kWgRows - 1) / kWgRows, a.H, a.B);
  kernel<<<grid, kWgThreads, kWgDqSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.out),
      static_cast<const __nv_bfloat16*>(a.dout), a.m, a.l, a.di,
      static_cast<__nv_bfloat16*>(a.dq), a.lengths, a.H, a.L, a.in, a.os, a.gs, a.scale,
      a.drop);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wgmma(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = attention_bwd_dkv_wgmma_kernel;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, kWgDkvSmem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + kWgRows - 1) / kWgRows, a.H, a.B);
  kernel<<<grid, kWgThreads, kWgDkvSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.m,
      a.l, a.di, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.lengths, a.H, a.L, a.in, a.os, a.gs, a.scale, a.drop);
  return cudaGetLastError();
}

template <bool kDq>
cudaError_t dispatch(int dtype, int D, const BwdArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.L <= 0) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 64) {  // the tensor-core bodies
    const void* ptrs[] = {a.q, a.k, a.v, a.dout, kDq ? a.out : a.dout,
                          kDq ? a.dq : a.dk, kDq ? a.dq : a.dv};
    for (const void* p : ptrs)
      if (!aligned16(p)) return cudaErrorMisalignedAddress;
    if (!rows_of_8(a.in) || !rows_of_8(a.os) || !rows_of_8(a.gs))
      return cudaErrorMisalignedAddress;
    return kDq ? launch_dq_wgmma(a, stream) : launch_dkv_wgmma(a, stream);
  }
#define DPH_BWD_CASE(T, DD) \
  return kDq ? launch_dq<T, DD>(a, stream) : launch_dkv<T, DD>(a, stream)
  if (dtype == 0) {
    if (D == 64) DPH_BWD_CASE(float, 64);
    if (D == 80) DPH_BWD_CASE(float, 80);
  } else if (dtype == 1) {
    if (D == 80) DPH_BWD_CASE(__nv_bfloat16, 80);
  }
#undef DPH_BWD_CASE
  return cudaErrorInvalidValue;
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const void* m, const void* l, void* di,
                  void* dq, void* dk, void* dv, const void* lengths,
                  const void* seed, unsigned threshold, float inv_keep, int B,
                  int L, int H, Strides in, Strides os, Strides gs,
                  float scale) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out; a.dout = dout;
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.di = static_cast<float*>(di);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lengths = static_cast<const int*>(lengths);
  a.B = B; a.H = H; a.L = L;
  a.in = in;
  a.os = os;
  a.gs = gs;
  a.scale = scale;
  a.drop = Dropout{static_cast<const int*>(seed), threshold,
                   seed != nullptr ? inv_keep : 1.f};
  return a;
}

// Strides of a contiguous (B, L, H*D) tensor and of a contiguous
// (B, H, L, D) one, as (batch, row, head).
Strides packed_rows(int L, int H, int D) {
  return Strides{(long long)L * H * D, (long long)H * D, D};
}
Strides head_rows(int L, int H, int D) {
  return Strides{(long long)H * L * D, (long long)D, (long long)L * D};
}

}  // namespace

extern "C" {

// q, k, v: (B, L, H*D) views with element strides (in_batch, in_row) and
// head stride D (slices of the fused QKV output).  out, dout: contiguous
// (B, L, H*D).  m, l: the forward's (B, H, L) fp32 statistics.  di: (B, H, L)
// fp32, written here.  dq: a (B, L, H*D) view with strides (g_batch, g_row),
// e.g. the first third of a (B, L, 3*H*D) gradient buffer.  lengths, seed,
// threshold, inv_keep and dtype as for packed_attention_fwd.
int packed_attention_bwd_dq(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* m,
                            const void* l, void* di, void* dq,
                            const void* lengths, const void* seed,
                            unsigned threshold, float inv_keep, int B, int L,
                            int H, int D, long long in_batch, long long in_row,
                            long long g_batch, long long g_row, float scale,
                            int dtype, void* stream) {
  const BwdArgs a = make_args(q, k, v, out, dout, m, l, di, dq, nullptr,
                              nullptr, lengths, seed, threshold, inv_keep, B,
                              L, H, Strides{in_batch, in_row, D},
                              packed_rows(L, H, D), Strides{g_batch, g_row, D},
                              scale);
  return dispatch<true>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// As packed_attention_bwd_dq, reading the di it wrote; dk and dv are views
// with the gradient strides (g_batch, g_row).
int packed_attention_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             const void* di, void* dk, void* dv,
                             const void* lengths, const void* seed,
                             unsigned threshold, float inv_keep, int B, int L,
                             int H, int D, long long in_batch,
                             long long in_row, long long g_batch,
                             long long g_row, float scale, int dtype,
                             void* stream) {
  const BwdArgs a = make_args(q, k, v, nullptr, dout, m, l,
                              const_cast<void*>(di), nullptr, dk, dv, lengths,
                              seed, threshold, inv_keep, B, L, H,
                              Strides{in_batch, in_row, D}, packed_rows(L, H, D),
                              Strides{g_batch, g_row, D}, scale);
  return dispatch<false>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// The (B, H, L, D) layout of flash_attention_fwd.  q, k, v: views with
// element strides (batch, head, row) and unit stride along D.  out, dout,
// and the gradients dq, dk, dv: contiguous (B, H, L, D).  m, l, di: (B, H, L)
// fp32 as for the packed entry points; lengths, seed, threshold, inv_keep
// and dtype as for packed_attention_fwd.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* out, const void* dout, const void* m,
                           const void* l, void* di, void* dq,
                           const void* lengths, const void* seed,
                           unsigned threshold, float inv_keep, int B, int H,
                           int L, int D, long long stride_batch,
                           long long stride_head, long long stride_row,
                           float scale, int dtype, void* stream) {
  const BwdArgs a = make_args(q, k, v, out, dout, m, l, di, dq, nullptr,
                              nullptr, lengths, seed, threshold, inv_keep, B,
                              L, H, Strides{stride_batch, stride_row, stride_head},
                              head_rows(L, H, D), head_rows(L, H, D), scale);
  return dispatch<true>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// As flash_attention_bwd_dq, reading the di it wrote.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* m, const void* l,
                            const void* di, void* dk, void* dv,
                            const void* lengths, const void* seed,
                            unsigned threshold, float inv_keep, int B, int H,
                            int L, int D, long long stride_batch,
                            long long stride_head, long long stride_row,
                            float scale, int dtype, void* stream) {
  const BwdArgs a = make_args(q, k, v, nullptr, dout, m, l,
                              const_cast<void*>(di), nullptr, dk, dv, lengths,
                              seed, threshold, inv_keep, B, L, H,
                              Strides{stride_batch, stride_row, stride_head},
                              head_rows(L, H, D), head_rows(L, H, D), scale);
  return dispatch<false>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
