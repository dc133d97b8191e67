// Attention forward for Hopper (sm_90a): softmax(scale * q k^T + key mask) v,
// with optional attention-probability dropout.
//
// Replaces two Pallas kernels of the TPU package:
//   * ops/packed_attention.py::_heads_loop_fwd (launched by _fwd_call), the
//     packed (B, L, H*D) layout, entry point packed_attention_fwd; with
//     dropout for training, and the softmax statistics m and l written for
//     the backward kernels of attention_bwd.cu when the caller asks;
//   * ops/flash_attention.py::_fwd_kernel (launched by _fwd), the
//     (B, H, L, D) layout that also stores the softmax statistics m and l,
//     entry point flash_attention_fwd (no dropout: its backward is not
//     ported, so the flash route serves only).
// Both layouts differ only in strides, so one templated body serves both.
//
// Semantics (as the Pallas kernels):
//   s = (q . k) * scale in fp32; key column c of batch b is masked with
//   NEG_INF when c >= min(lengths[b], L) (padded query rows still attend to
//   the valid keys); online softmax with m, l in fp32; p is rounded to the
//   input type before the PV product, as flash_attention.py's _fwd_kernel
//   does; with dropout, p is zeroed where the hash drops it (l keeps the
//   undropped sum) and the output is scaled by 1/(1 - rate), as
//   packed_attention.py:101-107; out = acc / l with 1/l taken as 1 when
//   l == 0.  A row whose length is 0 sees every key masked and so averages v
//   over all L rows, like the plain version.
//
// What bounds it on an H100: at the serving and training shapes (L ~ 750-
// 1300, D = 64) the work is 4*B*H*L^2*D operations against ~4*B*L*H*D*bytes
// of traffic, i.e. well above the card's ridge point: the kernel is bound by
// operations.  This first version computes on the CUDA cores with fp32 FMA
// (67 TFLOP/s peak, against 989 TFLOP/s for bf16 on the tensor cores), so it
// sits far above the bound; wgmma/mma.sync tiles are the later step.  What
// the design does about the bound:
//   * one block per (64-row q tile, head, batch), 256 threads, each thread a
//     4x4 register tile of scores and a 4x(D/16) tile of the output, so each
//     value read from shared memory feeds four FMAs;
//   * K and V tiles of 64 rows are staged in shared memory as fp32 (rows of
//     K and P padded by one float so that a warp's reads hit distinct banks);
//   * KV tiles wholly past lengths[b] are skipped (their p is exactly 0), so
//     short clips in a padded batch cost what their length needs;
//   * q, k and v are read through (batch, row, head) strides, so the packed
//     entry reads the fused QKV projection output in place, without copies;
//   * the dropout mask is a hash of the element's coordinates computed in
//     registers (16 per thread per tile), never a tensor in memory.
#include "attention_common.cuh"

namespace {

constexpr int smem_floats(int d) {
  return kBlockQ * (d + 1) + kBlockKV * (d + 1) + kBlockKV * d +
         kBlockQ * kPStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         const int* __restrict__ lengths, int H, int L,
                         Strides in, Strides os, float scale, Dropout drop) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KP = D + 1;       // padded row of sQ and sK
  constexpr int DPT = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                   // kBlockQ x KP
  float* sK = sQ + kBlockQ * KP;      // kBlockKV x KP
  float* sV = sK + kBlockKV * KP;     // kBlockKV x D
  float* sP = sV + kBlockKV * D;      // kBlockQ x kPStride

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: kv columns tx + 16 j
  const int ty = tid >> 4;  // row group: q rows 4 ty .. 4 ty + 3
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int len = L;
  if (lengths != nullptr) len = max(0, min(lengths[b], L));
  // Tiles past the valid keys hold only masked columns: skip them, except
  // for a row with no valid key, which averages over all of them.
  const int kv_end = len > 0 ? len : L;
  const bool dropout = drop.seed != nullptr;
  const unsigned bh_seed = dropout ? dropout_bh_seed(drop.seed, b, h) : 0u;

  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    sQ[r * KP + c] = row < L ? to_float(qb[row * in.row + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    for (int i = tid; i < kBlockKV * D; i += kThreads) {
      const int r = i / D, c = i % D, row = kv0 + r;
      const bool ok = row < L;
      sK[r * KP + c] = ok ? to_float(kb[row * in.row + c]) : 0.f;
      sV[r * D + c] = ok ? to_float(vb[row * in.row + c]) : 0.f;
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
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        // columns past L do not exist (excluded); columns past the length
        // are masked with the finite NEG_INF, as in the Pallas kernels
        float x = s[i][j] * scale;
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
      const unsigned row = q0 + 4 * ty + i;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned col = kv0 + tx + 16 * j;
        const float p = expf(s[i][j] - m_next);
        row_sum += p;  // l is the undropped sum
        float kept = round_to<T>(p);
        if (dropout && !dropout_keep(bh_seed, row, col, drop.threshold))
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

  const long long obase = (long long)b * os.batch + (long long)h * os.head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
    const float l_inv = (l[i] == 0.f ? 1.f : 1.f / l[i]) * drop.inv_keep;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      out[obase + row * os.row + tx + 16 * d] = from_float<T>(acc[i][d] * l_inv);
    if (m_out != nullptr && tx == 0) {
      const long long idx = ((long long)b * H + h) * L + row;
      m_out[idx] = m[i];
      l_out[idx] = l[i];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m, float* l, const int* lengths, int B, int H, int L,
                   Strides in, Strides os, float scale, Dropout drop,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats(D);
  auto kernel = attention_fwd_kernel<T, D>;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m, l, lengths, H, L, in,
      os, scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, float* m, float* l, const int* lengths,
                       int B, int H, int L, Strides in, Strides os,
                       float scale, Dropout drop, cudaStream_t stream) {
  switch (D) {
    // 64: Base and Large (768/12, 1024/16); 80: XLarge (1280/16)
    case 64: return launch<T, 64>(q, k, v, out, m, l, lengths, B, H, L, in, os, scale, drop, stream);
    case 80: return launch<T, 80>(q, k, v, out, m, l, lengths, B, H, L, in, os, scale, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, void* out, float* m, float* l,
                     const int* lengths, int B, int H, int L, Strides in,
                     Strides os, float scale, Dropout drop,
                     cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, m, l, lengths, B, H, L, in, os, scale, drop, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, m, l, lengths, B, H, L, in, os, scale, drop, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v: (B, L, H*D) views with element strides (batch, row) and head
// stride D, e.g. slices of the fused QKV output (B, L, 3*H*D).
// out: contiguous (B, L, H*D).  m, l: contiguous (B, H, L) float32, or both
// null when no backward follows.  lengths: (B,) int32 or null.  seed: one
// int32 on the card, or null for no dropout; threshold and inv_keep as in
// attention_common.cuh.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
int packed_attention_fwd(const void* q, const void* k, const void* v,
                         void* out, void* m, void* l, const void* lengths,
                         const void* seed, unsigned threshold, float inv_keep,
                         int B, int L, int H, int D, long long stride_batch,
                         long long stride_row, float scale, int dtype,
                         void* stream) {
  const Strides in{stride_batch, stride_row, D};
  const Strides os{(long long)L * H * D, (long long)H * D, D};
  const Dropout drop{static_cast<const int*>(seed), threshold,
                     seed != nullptr ? inv_keep : 1.f};
  return dispatch(dtype, D, q, k, v, out, static_cast<float*>(m),
                  static_cast<float*>(l), static_cast<const int*>(lengths), B,
                  H, L, in, os, scale, drop, static_cast<cudaStream_t>(stream));
}

// q, k, v: (B, H, L, D) views with element strides (batch, head, row).
// out: contiguous (B, H, L, D); m, l: contiguous (B, H, L) float32.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* m, void* l, const void* lengths,
                        int B, int H, int L, int D, long long stride_batch,
                        long long stride_head, long long stride_row,
                        float scale, int dtype, void* stream) {
  const Strides in{stride_batch, stride_row, stride_head};
  const Strides os{(long long)H * L * D, (long long)D, (long long)L * D};
  const Dropout drop{nullptr, 0u, 1.f};
  return dispatch(dtype, D, q, k, v, out, static_cast<float*>(m),
                  static_cast<float*>(l), static_cast<const int*>(lengths), B,
                  H, L, in, os, scale, drop, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
