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
//     entry point flash_attention_fwd; with dropout for training, and m and
//     l read by the flash backward kernels of attention_bwd.cu.
// Both layouts differ only in strides, so each body below serves both.
//
// Semantics (as the Pallas kernels):
//   s = (q . k) * scale in fp32; key column c of batch b is masked with
//   NEG_INF when c >= min(lengths[b], L) (padded query rows still attend to
//   the valid keys); online softmax with m, l in fp32; p is rounded to the
//   input type before the PV product, as flash_attention.py's _fwd_kernel
//   does; with dropout, p is zeroed where the hash drops it (l keeps the
//   undropped sum) and the output is scaled by 1/(1 - rate), as
//   packed_attention.py:101-107 and flash_attention.py:127-146; the mask's
//   coordinates are absolute (b, h, row, col), so the TPU kernels' tiling
//   and padding change none of its bits; out = acc / l with 1/l taken as 1 when
//   l == 0.  A row whose length is 0 sees every key masked and so averages v
//   over all L rows, like the plain version.
//
// What bounds it on an H100: at the serving and training shapes (L ~ 750-
// 1300, D = 64) the work is 4*B*H*L^2*D operations against ~4*B*L*H*D*bytes
// of traffic, i.e. well above the card's ridge point: the kernel is bound by
// operations.  Two bodies, chosen at run time by (dtype, D) in dispatch():
//   * bf16 at D = 64, every training step and bf16 serving on the card:
//     attention_fwd_wgmma_kernel below, both products on the tensor cores
//     (989 TFLOP/s bf16).  Its body is attention_fwd_wgmma.cuh's template
//     without the gated bias (WavLM's forward is the same template with
//     it): one warpgroup (128 threads) per (64-row q tile, head, batch), the
//     Q tile resident, K and V tiles through a two-stage 16-byte cp.async
//     ring of 128-byte-swizzled bf16 tiles, S = Q K^T and O += P V as wgmma
//     m64n64k16, the online softmax on S's accumulator in registers, the
//     unnormalised p packed in place into the bf16 A operand of the PV
//     product (P never goes through shared memory).  m stays in the units
//     of scale * s, as the backward bodies read it.
//   * fp32 (any D) and D = 80 (any dtype): attention_fwd_kernel, fp32 FMA
//     on the CUDA cores (67 TFLOP/s peak).  fp32 is the path of the card-
//     vs-CPU checks, which TF32 products would break; no configuration
//     trains at D = 80 on the card.  256 threads, each a 4x4 register tile
//     of scores and a 4x(D/16) tile of the output, so each value read from
//     shared memory feeds four FMAs; K and V tiles of 64 rows staged in
//     shared memory as fp32 (rows of K and P padded by one float so that a
//     warp's reads hit distinct banks).
// Both bodies skip KV tiles wholly past lengths[b] (their p is exactly 0),
// so short clips in a padded batch cost what their length needs; read q, k
// and v through (batch, row, head) strides, so the packed entry reads the
// fused QKV projection output in place, without copies; and compute the
// dropout mask as a hash of the element's coordinates in registers, never
// a tensor in memory.
#include "attention_common.cuh"
#include "attention_fwd_wgmma.cuh"

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

// One (64-row q tile, head, batch) on the tensor cores, bf16 at D = 64;
// arguments as attention_fwd_kernel's.  The body is attention_fwd_wgmma.cuh's,
// without the gated bias.
__global__ void __launch_bounds__(kWgThreads)
    attention_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ m_out,
                               float* __restrict__ l_out,
                               const int* __restrict__ lengths, int H, int L,
                               Strides in, Strides os, float scale,
                               Dropout drop) {
  attention_fwd_wgmma_body<false>(q, k, v, out, m_out, l_out, lengths, H, L, in, os, scale,
                                  drop, GatedBias{nullptr, nullptr}, blockIdx.x, blockIdx.y,
                                  blockIdx.z);
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

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* m, float* l, const int* lengths,
                         int B, int H, int L, Strides in, Strides os,
                         float scale, Dropout drop, cudaStream_t stream) {
  auto kernel = attention_fwd_wgmma_kernel;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, kWgFwdSmem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kWgRows - 1) / kWgRows, H, B);
  kernel<<<grid, kWgThreads, kWgFwdSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), m,
      l, lengths, H, L, in, os, scale, drop);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, void* out, float* m, float* l,
                     const int* lengths, int B, int H, int L, Strides in,
                     Strides os, float scale, Dropout drop,
                     cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 64) {  // the tensor-core body, or an error
    const void* ptrs[] = {q, k, v, out};
    for (const void* p : ptrs)
      if (!aligned16(p)) return cudaErrorMisalignedAddress;
    if (!rows_of_8(in) || !rows_of_8(os)) return cudaErrorMisalignedAddress;
    return launch_wgmma(q, k, v, out, m, l, lengths, B, H, L, in, os, scale, drop, stream);
  }
#define DPH_FWD_CASE(T, DD) \
  return launch<T, DD>(q, k, v, out, m, l, lengths, B, H, L, in, os, scale, drop, stream)
  // 64: Base and Large (768/12, 1024/16); 80: XLarge (1280/16)
  if (dtype == 0) {
    if (D == 64) DPH_FWD_CASE(float, 64);
    if (D == 80) DPH_FWD_CASE(float, 80);
  } else if (dtype == 1) {
    if (D == 80) DPH_FWD_CASE(__nv_bfloat16, 80);
  }
#undef DPH_FWD_CASE
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
// lengths, seed, threshold, inv_keep and dtype as for packed_attention_fwd.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* m, void* l, const void* lengths,
                        const void* seed, unsigned threshold, float inv_keep,
                        int B, int H, int L, int D, long long stride_batch,
                        long long stride_head, long long stride_row,
                        float scale, int dtype, void* stream) {
  const Strides in{stride_batch, stride_row, stride_head};
  const Strides os{(long long)H * L * D, (long long)D, (long long)L * D};
  const Dropout drop{static_cast<const int*>(seed), threshold,
                     seed != nullptr ? inv_keep : 1.f};
  return dispatch(dtype, D, q, k, v, out, static_cast<float*>(m),
                  static_cast<float*>(l), static_cast<const int*>(lengths), B,
                  H, L, in, os, scale, drop, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
