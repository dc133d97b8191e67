// LayerNorm and GroupNorm with fp32 statistics, forward and backward, for
// Hopper (sm_90a): the kernels of ops/norm.py.
//
// Replaces no Pallas kernel.  The TPU package left its LayerNorm and
// GroupNorm (models/components.py::_layer_norm) to XLA, which fuses them;
// on the card the port ran them as eager aten passes: a cast to fp32, two
// means, a square, the affine's products and sums and a cast back, and
// about as many again in autograd's backward, which also kept the fp32 copy
// of the input.  Here the forward reads x once and writes y once, and the
// backward reads x and dy once and writes dx once.
//
// What bounds it on an H100: bytes.  A norm does about ten operations an
// element against 4 (bf16 forward) to 6 (bf16 backward) bytes moved, far
// under the card's ridge point, so its bound is bytes / 3.35 TB/s, and the
// design keeps every pass over a row after the first on chip.
//
// Semantics (ops/norm.py's plain versions, norm_reference and
// norm_bwd_reference): over each normalised row of n elements the mean and
// the variance in fp32 by two passes over the row held on chip, the
// variance clamped at 0; rstd = rsqrt(var + eps); y = (x - mean) * rstd * w
// + b in fp32, rounded to x's type.  The backward, with xh = (x - mean) *
// rstd from the saved mean and rstd and g = dy * w:
//   dx = rstd * (g - mean(g) - xh * mean(g * xh)),
//   dw = sum of dy * xh, db = sum of dy, over every element an entry scales.
// The affine lies along the reduced dimension (LayerNorm: w[j]) or along
// the rows (GroupNorm(C, C): w[(row / div) % groups]), or is absent.
//
// Two memory geometries, which the wrapper picks from the input's shape and
// strides (ops/norm.py::norm_geometry):
//   * rows: the reduced dimension has unit stride and the rows lie a fixed
//     stride apart (LayerNorm over the last dimension; GroupNorm over
//     time).  Rows of up to 1024 elements go one to a warp, held in
//     registers (norm_fwd_rows_warp, norm_bwd_rows_warp);
//     longer rows one to a block (norm_fwd_rows_block, norm_bwd_rows_block),
//     staged in shared memory (the GroupNorm's rows of 49,983 frames: 100 KB
//     in bf16, 200 KB with dy in the backward) or, past 227 KB, read again
//     from device memory.  16-byte loads and stores where the pointers
//     allow, a long row's ragged ends one element at a time.
//   * strided: the reduced dimension's elements lie a fixed stride apart and
//     another dimension has unit stride (the channel LayerNorm over dim 1 of
//     (B, C, T); the feature projection's LayerNorm over the extractor's
//     transposed output).  A block takes a tile of all n channels x 32
//     consecutive frames into shared memory, each warp reading 32 frames of
//     one channel at a time (norm_fwd_strided, norm_bwd_strided).  The
//     backward reads dy in its own layout: the projection's comes back with
//     the channels at unit stride, and its tile is read as one contiguous
//     stretch, with no copy to x's strides.
// The affine's gradient is a sum over many blocks: each block (the warp
// kernel, the strided kernel) or each row (the block kernel) writes partial
// sums, and norm_bwd_affine_sum adds them in a fixed order.  No float
// atomics anywhere, so a replayed CUDA graph gives the eager call's bits,
// and one run gives the next one's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps a block of the warp and strided kernels
constexpr int kTile = 32;               // frames a strided tile
constexpr int kBlockMax = 1024;         // threads a block of the block kernels
// dynamic shared memory a block may take: the SM's 227 KB less room for
// the kernels' static arrays (2.5 KB at most)
constexpr int kSmemMax = 232448 - 4096;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
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

// Elements in 16 bytes.
template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / sizeof(T);
}

// Vectors a lane holds at most in the warp kernels.
template <typename T>
constexpr int kMaxSlots = sizeof(T) == 4 ? 8 : 4;

template <typename T>
union Vec16 {
  uint4 raw;
  T e[vec_of<T>()];
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  Vec16<T> u;
  u.raw = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < vec_of<T>(); ++i) v[i] = to_float(u.e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  Vec16<T> u;
#pragma unroll
  for (int i = 0; i < vec_of<T>(); ++i) u.e[i] = from_float<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = u.raw;
}

// The butterfly leaves the same bits in every lane (each step adds the same
// two operands in both lanes of a pair).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v in a fixed order, returned to every thread.  red:
// 33 float2 of shared memory; the two barriers let the next call reuse it.
__device__ float2 block_sum2(float2 v, float2* red) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float2 s = lane < (int)((blockDim.x + 31) >> 5) ? red[lane] : make_float2(0.f, 0.f);
    s.x = warp_sum(s.x);
    s.y = warp_sum(s.y);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// Where a normalised row lies, for both geometries.  rows: row r spans
// elements [r * so, r * so + n); strided: row (o, i) holds elements
// o * so + c * sn + i for c < n, i < inner.
struct Geometry {
  long long outer;  // rows, or the outer index's extent
  long long inner;  // 1, or the unit-stride index's extent
  long long so;     // stride of the row (rows) or of the outer index (strided)
  long long sn;     // stride of the reduced dimension (1 for rows)
  int n;            // reduced length
  int affine;       // 0 none, 1 w[j] along the reduced dimension, 2 w[(row / div) % groups]
  long long groups;
  long long div;
};

__device__ __forceinline__ long long affine_row(const Geometry& g, long long r) {
  return (r / g.div) % g.groups;
}

// ---------------------------------------------------------------------------
// rows, one a warp: n <= 32 * K * V, the row in registers.  Lane l holds
// slots (k, i): element (l + 32 k) V + i with 16-byte vectors (vec: n, the
// row stride and every pointer aligned to them), else l + 32 (k V + i).
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ int slot(int lane, int k, int i, bool vec) {
  return vec ? (lane + 32 * k) * V + i : lane + 32 * (k * V + i);
}

template <typename T, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int n, int lane, bool vec,
                                         float (&v)[K][vec_of<T>()]) {
  constexpr int V = vec_of<T>();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (vec) {
      const int j = (lane + 32 * k) * V;
      if (j < n) {
        load_vec(p + j, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = slot<V>(lane, k, i, false);
        v[k][i] = j < n ? to_float(p[j]) : 0.f;
      }
    }
  }
}

template <typename T, int K>
__device__ __forceinline__ void store_row(T* __restrict__ p, int n, int lane, bool vec,
                                          const float (&v)[K][vec_of<T>()]) {
  constexpr int V = vec_of<T>();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (vec) {
      const int j = (lane + 32 * k) * V;
      if (j < n) store_vec(p + j, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = slot<V>(lane, k, i, false);
        if (j < n) p[j] = from_float<T>(v[k][i]);
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kWarps * 32)
    norm_fwd_rows_warp(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, Geometry g, float eps, bool vec) {
  constexpr int V = vec_of<T>();
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= g.outer) return;
  const int lane = threadIdx.x & 31, n = g.n;
  float v[K][V];
  load_row<T, K>(x + r * g.so, n, lane, vec, v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[k][i];  // the empty slots hold 0
  const float mean = warp_sum(s) / n;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = slot<V>(lane, k, i, vec) < n ? v[k][i] - mean : 0.f;
      q += d * d;
    }
  const float rstd = rsqrtf(fmaxf(warp_sum(q) / n, 0.f) + eps);
  float wr = 1.f, br = 0.f;
  if (g.affine == 2) {
    const long long a = affine_row(g, r);
    wr = w[a];
    br = b[a];
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = slot<V>(lane, k, i, vec);
      float o = (v[k][i] - mean) * rstd;
      if (g.affine == 1) {
        o = j < n ? o * w[j] + b[j] : 0.f;
      } else {
        o = o * wr + br;
      }
      v[k][i] = o;
    }
  store_row<T, K>(y + r * g.so, n, lane, vec, v);
  if (lane == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// Rows strided over the grid's warps.  With the affine along the row
// (affine 1) and pw given, each warp adds dy * xh and dy of its rows into
// its own two rows of shared memory, laid out by slot ((k V + i) 32 + lane:
// a lane's own words, no bank conflicts); the block adds its warps' rows
// in order and writes row blockIdx.x of pw and pb (n floats each, by
// column).  With the affine over rows (affine 2), pw[r] and pb[r] get the
// row's sums.
template <typename T, int K>
__global__ void __launch_bounds__(kWarps * 32, 2)
    norm_bwd_rows_warp(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                       const float* __restrict__ w, const float* __restrict__ mean,
                       const float* __restrict__ rstd, float* __restrict__ pw,
                       float* __restrict__ pb, Geometry g, bool vec) {
  constexpr int V = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n = g.n;
  constexpr int S = 32 * K * V;  // slots a warp
  const bool column = g.affine == 1 && pw != nullptr;
  float* sw = reinterpret_cast<float*>(smem) + 2 * warp * S;  // this warp's dw row
  float* sb = sw + S;                                          // and db row
  if (column)
    for (int t = lane; t < S; t += 32) sw[t] = sb[t] = 0.f;
  __syncwarp();
  const long long step = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < g.outer; r += step) {
    float xv[K][V], dv[K][V];
    load_row<T, K>(x + r * g.so, n, lane, vec, xv);
    load_row<T, K>(dy + r * g.so, n, lane, vec, dv);
    const float m = mean[r], rs = rstd[r];
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = slot<V>(lane, k, i, vec);
        const bool in = j < n;
        const float xh = in ? (xv[k][i] - m) * rs : 0.f;
        const float gp = g.affine == 1 ? (in ? dv[k][i] * w[j] : 0.f) : dv[k][i];
        t1 += gp;
        t2 += gp * xh;
        if (column) {  // the empty slots add 0
          sw[(k * V + i) * 32 + lane] += dv[k][i] * xh;
          sb[(k * V + i) * 32 + lane] += dv[k][i];
        }
        xv[k][i] = xh;
        dv[k][i] = gp;
      }
    t1 = warp_sum(t1);
    t2 = warp_sum(t2);
    const float scale = g.affine == 2 ? w[affine_row(g, r)] : 1.f;
    const float c1 = scale * t1 / n, c2 = scale * t2 / n;
    if (dx != nullptr) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) xv[k][i] = rs * (dv[k][i] * scale - c1 - xv[k][i] * c2);
      store_row<T, K>(dx + r * g.so, n, lane, vec, xv);
    }
    if (g.affine == 2 && pw != nullptr && lane == 0) {
      pw[r] = t2;
      pb[r] = t1;
    }
  }
  if (!column) return;
  __syncthreads();
  const float* rows = reinterpret_cast<const float*>(smem);
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const int j = slot<V>(t & 31, t / 32 / V, t / 32 % V, vec);
    if (j >= n) continue;
    float aw = 0.f, ab = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      aw += rows[2 * k * S + t];
      ab += rows[(2 * k + 1) * S + t];
    }
    pw[(long long)blockIdx.x * n + j] = aw;
    pb[(long long)blockIdx.x * n + j] = ab;
  }
}

// ---------------------------------------------------------------------------
// rows, one a block: any n.  for_row hands each thread its part of the row
// [lo, lo + n) (absolute element offsets): with vec, whole 16-byte vectors
// (full(a)) and the ragged ends' elements one at a time (one(a)); else
// every element one at a time.  With CACHE the row (and dy) is staged in
// shared memory first, at offset a - base, which keeps the vectors'
// alignment.
// ---------------------------------------------------------------------------

template <int V, typename Full, typename One>
__device__ __forceinline__ void for_row(long long lo, int n, bool vec, Full full, One one) {
  const long long end = lo + n;
  if (vec) {
    const long long stride = (long long)blockDim.x * V;
#pragma unroll 2
    for (long long a = lo / V * V + (long long)threadIdx.x * V; a < end; a += stride) {
      if (a >= lo && a + V <= end) {
        full(a);
      } else {
        for (int i = 0; i < V; ++i)
          if (a + i >= lo && a + i < end) one(a + i);
      }
    }
  } else {
    for (long long a = lo + threadIdx.x; a < end; a += blockDim.x) one(a);
  }
}

template <typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ src, T* cache, long long lo,
                                          long long base, int n, bool vec) {
  constexpr int V = vec_of<T>();
  for_row<V>(
      lo, n, vec,
      [&](long long a) {
        *reinterpret_cast<uint4*>(cache + (a - base)) = *reinterpret_cast<const uint4*>(src + a);
      },
      [&](long long a) { cache[a - base] = src[a]; });
}

// Elements a staged row's cache holds: n and both ragged ends' vectors.
template <typename T>
__host__ __device__ constexpr long long cache_span(int n) {
  return ((long long)n + 2 * vec_of<T>() + vec_of<T>() - 1) / vec_of<T>() * vec_of<T>();
}

template <typename T, bool CACHE>
__global__ void __launch_bounds__(kBlockMax)
    norm_fwd_rows_block(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, Geometry g, float eps, bool vec) {
  constexpr int V = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red[33];
  const long long r = blockIdx.x, lo = r * g.so;
  const int n = g.n;
  const long long base = vec ? lo / V * V : lo;
  T* cache = reinterpret_cast<T*>(smem);
  if (CACHE) {
    stage_row(x, cache, lo, base, n, vec);
    __syncthreads();
  }
  auto src = [&](long long a) -> const T* { return CACHE ? cache + (a - base) : x + a; };
  float s = 0.f;
  for_row<V>(
      lo, n, vec,
      [&](long long a) {
        float v[V];
        load_vec(src(a), v);
#pragma unroll
        for (int i = 0; i < V; ++i) s += v[i];
      },
      [&](long long a) { s += to_float(*src(a)); });
  const float m = block_sum2(make_float2(s, 0.f), red).x / n;
  float q = 0.f;
  for_row<V>(
      lo, n, vec,
      [&](long long a) {
        float v[V];
        load_vec(src(a), v);
#pragma unroll
        for (int i = 0; i < V; ++i) q += (v[i] - m) * (v[i] - m);
      },
      [&](long long a) {
        const float d = to_float(*src(a)) - m;
        q += d * d;
      });
  const float rs = rsqrtf(fmaxf(block_sum2(make_float2(q, 0.f), red).x / n, 0.f) + eps);
  float wr = 1.f, br = 0.f;
  if (g.affine == 2) {
    const long long a = affine_row(g, r);
    wr = w[a];
    br = b[a];
  }
  auto norm = [&](float v, long long a) {
    const float o = (v - m) * rs;
    if (g.affine == 1) return o * w[a - lo] + b[a - lo];
    return o * wr + br;
  };
  for_row<V>(
      lo, n, vec,
      [&](long long a) {
        float v[V];
        load_vec(src(a), v);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = norm(v[i], a + i);
        store_vec(y + a, v);
      },
      [&](long long a) { y[a] = from_float<T>(norm(to_float(*src(a)), a)); });
  if (threadIdx.x == 0) {
    mean_out[r] = m;
    rstd_out[r] = rs;
  }
}

// The affine over rows (2) or none: the wrapper sends a long row with the
// affine along it to no kernel.  pw[r], pb[r]: the row's sums of dy * xh
// and dy.
template <typename T, bool CACHE>
__global__ void __launch_bounds__(kBlockMax)
    norm_bwd_rows_block(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                        const float* __restrict__ w, const float* __restrict__ mean,
                        const float* __restrict__ rstd, float* __restrict__ pw,
                        float* __restrict__ pb, Geometry g, bool vec) {
  constexpr int V = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red[33];
  const long long r = blockIdx.x, lo = r * g.so;
  const int n = g.n;
  const long long base = vec ? lo / V * V : lo;
  T* cx = reinterpret_cast<T*>(smem);
  T* cd = cx + cache_span<T>(n);
  if (CACHE) {
    stage_row(x, cx, lo, base, n, vec);
    stage_row(dy, cd, lo, base, n, vec);
    __syncthreads();
  }
  auto sx = [&](long long a) -> const T* { return CACHE ? cx + (a - base) : x + a; };
  auto sd = [&](long long a) -> const T* { return CACHE ? cd + (a - base) : dy + a; };
  const float m = mean[r], rs = rstd[r];
  float t1 = 0.f, t2 = 0.f;
  for_row<V>(
      lo, n, vec,
      [&](long long a) {
        float xv[V], dv[V];
        load_vec(sx(a), xv);
        load_vec(sd(a), dv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          t1 += dv[i];
          t2 += dv[i] * ((xv[i] - m) * rs);
        }
      },
      [&](long long a) {
        const float d = to_float(*sd(a));
        t1 += d;
        t2 += d * ((to_float(*sx(a)) - m) * rs);
      });
  const float2 t = block_sum2(make_float2(t1, t2), red);
  const float scale = g.affine == 2 ? w[affine_row(g, r)] : 1.f;
  const float c1 = scale * t.x / n, c2 = scale * t.y / n;
  if (dx != nullptr) {
    auto grad = [&](float xv, float dv) { return rs * (dv * scale - c1 - (xv - m) * rs * c2); };
    for_row<V>(
        lo, n, vec,
        [&](long long a) {
          float xv[V], dv[V];
          load_vec(sx(a), xv);
          load_vec(sd(a), dv);
#pragma unroll
          for (int i = 0; i < V; ++i) xv[i] = grad(xv[i], dv[i]);
          store_vec(dx + a, xv);
        },
        [&](long long a) { dx[a] = from_float<T>(grad(to_float(*sx(a)), to_float(*sd(a)))); });
  }
  if (g.affine == 2 && pw != nullptr && threadIdx.x == 0) {
    pw[r] = t.y;
    pb[r] = t.x;
  }
}

// ---------------------------------------------------------------------------
// strided: a block per tile of n channels x kTile frames (o, i0..i0+31);
// lane l takes frame i0 + l, warp w channels w, w + 8, ...
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    norm_fwd_strided(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, Geometry g, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[kWarps][kTile];
  __shared__ float stat[2][kTile];
  T* tile = reinterpret_cast<T*>(smem);  // n x kTile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n = g.n;
  const long long tiles_i = (g.inner + kTile - 1) / kTile;
  const long long o = blockIdx.x / tiles_i, i = (blockIdx.x % tiles_i) * kTile + lane;
  const bool in = i < g.inner;
  const long long at = o * g.so + i;
  float s = 0.f;
#pragma unroll 16
  for (int c = warp; c < n; c += kWarps) {
    const T v = in ? x[at + c * g.sn] : from_float<T>(0.f);
    tile[c * kTile + lane] = v;
    s += to_float(v);
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += part[k][lane];
    stat[0][lane] = t / n;
  }
  __syncthreads();
  const float m = stat[0][lane];
  float q = 0.f;
  for (int c = warp; c < n; c += kWarps) {
    const float d = to_float(tile[c * kTile + lane]) - m;
    q += d * d;
  }
  part[warp][lane] = q;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += part[k][lane];
    stat[1][lane] = rsqrtf(fmaxf(t / n, 0.f) + eps);
  }
  __syncthreads();
  const float rs = stat[1][lane];
  if (!in) return;
  for (int c = warp; c < n; c += kWarps) {
    float v = (to_float(tile[c * kTile + lane]) - m) * rs;
    if (g.affine == 1) v = v * w[c] + b[c];
    y[at + c * g.sn] = from_float<T>(v);
  }
  if (warp == 0) {
    mean_out[o * g.inner + i] = m;
    rstd_out[o * g.inner + i] = rs;
  }
}

// Padded row of a strided backward tile: an odd number of 32-bit words, so
// that 32 threads reading 32 channels at one frame hit 32 banks.
template <typename T>
__host__ __device__ constexpr int strided_pitch() {
  return sizeof(T) == 4 ? kTile + 1 : kTile + 2;
}

// Where dy's elements lie for the strided backward where they do not lie
// as x's: element (o, c, i) of the geometry at o * so + c * sn + i * si,
// with the channels at unit stride (sn = 1).  The feature projection's dy
// comes back so from its linear layer (si = n) while x has the frames at
// unit stride.
struct DyStrides {
  long long so, sn, si;
};

// Tiles strided over the grid; with pw, thread t sums dy * xh and dy of
// channels t, t + 256, ... over its block's tiles and writes row blockIdx.x
// of pw and pb.  dy's tile is read along its own unit-stride index: with
// x's strides, by frames beside x in the same loop (DY_CHANNELS false: d is
// not read), or channel-major in its own strides d, first, with
// consecutive threads on consecutive channels of one frame (DY_CHANNELS:
// the projection's dy, whose tile is one contiguous stretch of 32 n
// elements).
template <typename T, bool DY_CHANNELS>
__global__ void __launch_bounds__(kWarps * 32)
    norm_bwd_strided(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                     const float* __restrict__ w, const float* __restrict__ mean,
                     const float* __restrict__ rstd, float* __restrict__ pw,
                     float* __restrict__ pb, Geometry g, DyStrides d) {
  constexpr int P = strided_pitch<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[2][kWarps][kTile];
  __shared__ float stat[4][kTile];  // mean, rstd, mean(g), mean(g * xh)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n = g.n;
  float* acc_w = reinterpret_cast<float*>(smem);  // n
  float* acc_b = acc_w + n;                       // n
  T* tx = reinterpret_cast<T*>(acc_b + n);        // n x P
  T* td = tx + (long long)n * P;                  // n x P
  if (pw != nullptr)
    for (int c = threadIdx.x; c < n; c += blockDim.x) acc_w[c] = acc_b[c] = 0.f;
  const long long tiles_i = (g.inner + kTile - 1) / kTile, tiles = g.outer * tiles_i;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long o = t / tiles_i, i0 = (t % tiles_i) * kTile, i = i0 + lane;
    const bool in = i < g.inner;
    const long long at = o * g.so + i;
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {
      stat[0][lane] = in ? mean[o * g.inner + i] : 0.f;
      stat[1][lane] = in ? rstd[o * g.inner + i] : 0.f;
    }
    if (DY_CHANNELS) {
      const int frames = (int)(g.inner - i0 < kTile ? g.inner - i0 : kTile);
      const long long dat = o * d.so + i0 * d.si;
      for (int e = threadIdx.x; e < n * kTile; e += blockDim.x) {
        const int f = e / n, c = e - f * n;
        td[c * P + f] = f < frames ? dy[dat + f * d.si + c] : from_float<T>(0.f);
      }
    }
    __syncthreads();
    const float m = stat[0][lane], rs = stat[1][lane];
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int c = warp; c < n; c += kWarps) {
      const T xv = in ? x[at + c * g.sn] : from_float<T>(0.f);
      tx[c * P + lane] = xv;
      T dy_c;
      if (DY_CHANNELS) {
        dy_c = td[c * P + lane];
      } else {
        dy_c = in ? dy[at + c * g.sn] : from_float<T>(0.f);
        td[c * P + lane] = dy_c;
      }
      const float dv = to_float(dy_c);
      const float gp = g.affine == 1 ? dv * w[c] : dv;
      t1 += gp;
      t2 += gp * ((to_float(xv) - m) * rs);
    }
    part[0][warp][lane] = t1;
    part[1][warp][lane] = t2;
    __syncthreads();
    if (warp == 0) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        s1 += part[0][k][lane];
        s2 += part[1][k][lane];
      }
      stat[2][lane] = s1 / n;
      stat[3][lane] = s2 / n;
    }
    __syncthreads();
    if (dx != nullptr && in) {
      const float c1 = stat[2][lane], c2 = stat[3][lane];
      for (int c = warp; c < n; c += kWarps) {
        const float xh = (to_float(tx[c * P + lane]) - m) * rs;
        const float dv = to_float(td[c * P + lane]);
        const float gp = g.affine == 1 ? dv * w[c] : dv;
        dx[at + c * g.sn] = from_float<T>(rs * (gp - c1 - xh * c2));
      }
    }
    if (pw != nullptr) {
      // frames past inner hold x = dy = 0 and mean = rstd = 0: they add 0
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float sw = 0.f, sb = 0.f;
#pragma unroll 8
        for (int f = 0; f < kTile; ++f) {
          const float dv = to_float(td[c * P + f]);
          sw += dv * ((to_float(tx[c * P + f]) - stat[0][f]) * stat[1][f]);
          sb += dv;
        }
        acc_w[c] += sw;
        acc_b[c] += sb;
      }
    }
  }
  if (pw != nullptr)
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      pw[(long long)blockIdx.x * n + c] = acc_w[c];
      pb[(long long)blockIdx.x * n + c] = acc_b[c];
    }
}

// dw[c] = sum over q < nq, d < div of pw[(q * groups + c) * div + d], db
// from pb the same.  A block takes 32 entries c (its lanes) and 32 slices of
// the (q, d) terms (its warps: terms s, s + 32, ... in order), then adds the
// slices' sums in order: the same order at every call.
constexpr int kSumSlices = 32;

__global__ void __launch_bounds__(32 * kSumSlices)
    norm_bwd_affine_sum(const float* __restrict__ pw, const float* __restrict__ pb,
                        float* __restrict__ dw, float* __restrict__ db, long long nq,
                        long long groups, long long div) {
  __shared__ float part[2][kSumSlices][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + lane;
  float sw = 0.f, sb = 0.f;
  if (c < groups)
    for (long long t = slice; t < nq * div; t += kSumSlices) {
      const long long at = ((t / div) * groups + c) * div + t % div;
      sw += pw[at];
      sb += pb[at];
    }
  part[0][slice][lane] = sw;
  part[1][slice][lane] = sb;
  __syncthreads();
  if (slice == 0 && c < groups) {
    float tw = 0.f, tb = 0.f;
    for (int k = 0; k < kSumSlices; ++k) {
      tw += part[0][k][lane];
      tb += part[1][k][lane];
    }
    dw[c] = tw;
    db[c] = tb;
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

enum Route { kRowsWarp = 0, kRowsBlock = 1, kStrided = 2 };

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// One attribute call per kernel instantiation: dynamic shared memory above
// 48 KB has to be opted into.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) *configured = true;
  return err;
}

// The smallest K of 1, 2, 3, 4 (and 8 for float32) with 32 K V >= n, or
// 0: a row of up to 1024 elements either way (bf16 at K = 8 would spill).
template <typename T>
int warp_slots(int n) {
  const int slots[] = {1, 2, 3, 4, 8};
  for (int k : slots)
    if (k <= kMaxSlots<T> && 32 * k * vec_of<T>() >= n) return k;
  return 0;
}

int block_threads(int n, int per_thread) {
  const int want = (n + per_thread - 1) / per_thread;
  return want >= kBlockMax ? kBlockMax : (want + 31) / 32 * 32;
}

template <typename T>
cudaError_t fwd(const T* x, T* y, const float* w, const float* b, float* mean, float* rstd,
                int route, Geometry g, float eps, cudaStream_t stream) {
  constexpr int V = vec_of<T>();
  const bool aligned = aligned16(x) && aligned16(y);
  if (route == kRowsWarp) {
    const bool vec = aligned && g.n % V == 0 && g.so % V == 0;
    const dim3 grid((unsigned)((g.outer + kWarps - 1) / kWarps));
#define DPH_NORM_FWD_WARP(K)                                                             \
  norm_fwd_rows_warp<T, K><<<grid, kWarps * 32, 0, stream>>>(x, y, w, b, mean, rstd, g, \
                                                             eps, vec)
    switch (warp_slots<T>(g.n)) {
      case 1: DPH_NORM_FWD_WARP(1); break;
      case 2: DPH_NORM_FWD_WARP(2); break;
      case 3: DPH_NORM_FWD_WARP(3); break;
      case 4: DPH_NORM_FWD_WARP(4); break;
      case 8:
        if constexpr (kMaxSlots<T> == 8) {
          DPH_NORM_FWD_WARP(8);
          break;
        }
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
#undef DPH_NORM_FWD_WARP
    return cudaGetLastError();
  }
  if (route == kRowsBlock) {
    const size_t bytes = cache_span<T>(g.n) * sizeof(T);
    const int threads = block_threads(g.n, V);
    if (bytes <= (size_t)kSmemMax) {
      auto kernel = norm_fwd_rows_block<T, true>;
      static bool configured = false;
      cudaError_t err = allow_smem(kernel, &configured);
      if (err != cudaSuccess) return err;
      kernel<<<(unsigned)g.outer, threads, bytes, stream>>>(x, y, w, b, mean, rstd, g, eps,
                                                            aligned);
    } else {
      norm_fwd_rows_block<T, false><<<(unsigned)g.outer, threads, 0, stream>>>(
          x, y, w, b, mean, rstd, g, eps, aligned);
    }
    return cudaGetLastError();
  }
  if (route == kStrided) {
    const size_t bytes = (size_t)g.n * kTile * sizeof(T);
    if (bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
    auto kernel = norm_fwd_strided<T>;
    static bool configured = false;
    cudaError_t err = allow_smem(kernel, &configured);
    if (err != cudaSuccess) return err;
    const long long tiles = g.outer * ((g.inner + kTile - 1) / kTile);
    kernel<<<(unsigned)tiles, kWarps * 32, bytes, stream>>>(x, y, w, b, mean, rstd, g, eps);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd(const T* x, const T* dy, T* dx, const float* w, const float* mean,
                const float* rstd, float* dw, float* db, float* pw, float* pb, int grid,
                int route, Geometry g, DyStrides d, cudaStream_t stream) {
  constexpr int V = vec_of<T>();
  const bool aligned = aligned16(x) && aligned16(dy) && aligned16(dx);
  if (dw == nullptr) pw = pb = nullptr;
  if (route == kRowsWarp) {
    const bool vec = aligned && g.n % V == 0 && g.so % V == 0;
    // each warp's two rows of slots in shared memory
#define DPH_NORM_BWD_WARP(K)                                                               \
  {                                                                                        \
    const size_t bytes =                                                                   \
        g.affine == 1 && pw != nullptr ? 2 * sizeof(float) * kWarps * 32 * K * V : 0;      \
    static bool configured = false;                                                        \
    cudaError_t err = allow_smem(norm_bwd_rows_warp<T, K>, &configured);                   \
    if (err != cudaSuccess) return err;                                                    \
    norm_bwd_rows_warp<T, K><<<grid, kWarps * 32, bytes, stream>>>(x, dy, dx, w, mean, rstd, \
                                                                   pw, pb, g, vec);        \
  }
    switch (warp_slots<T>(g.n)) {
      case 1: DPH_NORM_BWD_WARP(1); break;
      case 2: DPH_NORM_BWD_WARP(2); break;
      case 3: DPH_NORM_BWD_WARP(3); break;
      case 4: DPH_NORM_BWD_WARP(4); break;
      case 8:
        if constexpr (kMaxSlots<T> == 8) {
          DPH_NORM_BWD_WARP(8);
          break;
        }
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
#undef DPH_NORM_BWD_WARP
  } else if (route == kRowsBlock) {
    if (g.affine == 1) return cudaErrorInvalidValue;
    const size_t bytes = 2 * cache_span<T>(g.n) * sizeof(T);
    const int threads = block_threads(g.n, V);
    if (bytes <= (size_t)kSmemMax) {
      auto kernel = norm_bwd_rows_block<T, true>;
      static bool configured = false;
      cudaError_t err = allow_smem(kernel, &configured);
      if (err != cudaSuccess) return err;
      kernel<<<(unsigned)g.outer, threads, bytes, stream>>>(x, dy, dx, w, mean, rstd, pw, pb, g,
                                                            aligned);
    } else {
      norm_bwd_rows_block<T, false><<<(unsigned)g.outer, threads, 0, stream>>>(
          x, dy, dx, w, mean, rstd, pw, pb, g, aligned);
    }
  } else if (route == kStrided) {
    const size_t bytes = 2 * sizeof(float) * g.n + 2 * sizeof(T) * g.n * strided_pitch<T>();
    if (bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
    const bool channels = d.sn == 1;
    if (!channels && (d.so != g.so || d.sn != g.sn || d.si != 1)) return cudaErrorInvalidValue;
    auto kernel = channels ? norm_bwd_strided<T, true> : norm_bwd_strided<T, false>;
    static bool configured[2] = {false, false};
    cudaError_t err = allow_smem(kernel, &configured[channels]);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWarps * 32, bytes, stream>>>(x, dy, dx, w, mean, rstd, pw, pb, g, d);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return err;
  // the partials: a row of n a block (affine 1) or one a row (affine 2)
  const long long groups = g.affine == 1 ? g.n : g.groups;
  const long long div = g.affine == 1 ? 1 : g.div;
  const long long nq = g.affine == 1 ? grid : g.outer * g.inner / (g.groups * g.div);
  norm_bwd_affine_sum<<<(unsigned)((groups + 31) / 32), 32 * kSumSlices, 0, stream>>>(
      pw, pb, dw, db, nq, groups, div);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward.  x, y: the same shape and strides, laid out as `route` and
// the geometry say (ops/norm.py::norm_geometry); w, b: float32 (n,) for
// affine 1, (groups,) for affine 2, or null for affine 0.  mean, rstd:
// float32, one per normalised row (outer * inner), row-major in (outer,
// inner).  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int norm_fwd(const void* x, void* y, const float* w, const float* b, float* mean, float* rstd,
             int route, long long outer, long long inner, long long so, long long sn, int n,
             int affine, long long groups, long long div, float eps, int dtype, void* stream) {
  if (outer <= 0 || inner <= 0 || n <= 0 || groups <= 0 || div <= 0) return cudaErrorInvalidValue;
  if ((affine != 0) != (w != nullptr && b != nullptr)) return cudaErrorInvalidValue;
  if (route == kStrided && affine == 2) return cudaErrorInvalidValue;
  const Geometry g{outer, inner, so, sn, n, affine, groups, div};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd(static_cast<const float*>(x), static_cast<float*>(y), w, b, mean, rstd, route, g,
               eps, s);
  if (dtype == 1)
    return fwd(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), w, b, mean,
               rstd, route, g, eps, s);
  return cudaErrorInvalidValue;
}

// The backward: dx (null: not wanted) with x's strides, from x, dy and the
// forward's mean and rstd.  dy: x's strides, with dy_so, dy_sn, dy_si =
// so, sn, 1 on route 2 (routes 0 and 1 read no others); or on route 2 its
// own with unit stride along the reduced dimension (dy_sn = 1), dy_so and
// dy_si along the geometry's outer and (for x) unit-stride indices.  dw,
// db: float32 like w, or
// null for no affine gradient; then pw and pb are float32 scratch: (grid,
// n) each for affine 1 (route 0 and 2), (outer,) each for affine 2.  grid:
// blocks of route 0 and 2 (each strides over the rows or tiles); route 1
// takes one block a row.  Returns a cudaError_t.
int norm_bwd(const void* x, const void* dy, void* dx, const float* w, const float* mean,
             const float* rstd, float* dw, float* db, float* pw, float* pb, int grid, int route,
             long long outer, long long inner, long long so, long long sn, int n, int affine,
             long long groups, long long div, long long dy_so, long long dy_sn,
             long long dy_si, int dtype, void* stream) {
  if (outer <= 0 || inner <= 0 || n <= 0 || groups <= 0 || div <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  if ((affine != 0) != (w != nullptr)) return cudaErrorInvalidValue;
  if (dw != nullptr && (affine == 0 || db == nullptr || pw == nullptr || pb == nullptr))
    return cudaErrorInvalidValue;
  if (route == kStrided && affine == 2) return cudaErrorInvalidValue;
  const Geometry g{outer, inner, so, sn, n, affine, groups, div};
  const DyStrides d{dy_so, dy_sn, dy_si};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd(static_cast<const float*>(x), static_cast<const float*>(dy),
               static_cast<float*>(dx), w, mean, rstd, dw, db, pw, pb, grid, route, g, d, s);
  if (dtype == 1)
    return bwd(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
               static_cast<__nv_bfloat16*>(dx), w, mean, rstd, dw, db, pw, pb, grid, route, g,
               d, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
