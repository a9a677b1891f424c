// Fused normalisations for Hopper (sm_90a): plain C interface for ctypes.
//
// Replaces no Pallas kernel.  The JAX package runs both norms as plain XLA
// (ai_rtc_agent_tpu/models/layers.py:115 group_norm, :129 layer_norm), which
// XLA fuses on the TPU; written as PyTorch ops they are an f32 copy, a
// var_mean over strided axes, four broadcast f32 passes and a cast (7-11
// launches, ~40-58 bytes moved an element with the SiLU after a
// GroupNorm).  Each norm here is one pass over the activation:
//
//   GroupNorm over NHWC [N, L, C] in G groups of C/G channels, statistics
//   per sample n and group g, optionally followed by SiLU:
//     y = act((x - mean[n,g]) * rsqrt(var[n,g] + eps) * scale[c] + bias[c])
//   LayerNorm over rows [R, C]:
//     y = (x - mean[r]) * rsqrt(var[r] + eps) * scale[c] + bias[c]
//
// Statistics (population variance), the affine and SiLU are f32; the output
// rounds once to the activation's type (bf16 or f32).  scale and bias are in
// the activation's type, as the served parameters are stored (cast_params),
// so the caller casts nothing.
//
// What bounds it: bytes.  A norm does ~10 flops an element, far below the
// ~295 flops a byte where the H100's compute would bind.  GroupNorm reads x
// twice (statistics, then apply) and writes y once: 6 B an element in bf16
// (the second read often hits the 50 MB L2); LayerNorm reads and writes
// once: 4 B an element.  Against 3.35 TB/s that is 1.8 ns (GroupNorm) and
// 1.2 ns (LayerNorm) a thousand elements.  How the design keeps to it:
// - Every element moves in 16-byte vector loads and stores (8 bf16 or two
//   float4), a thread owning 8 contiguous channels of a row.  Where C is not
//   a multiple of 8 or a pointer is not 16-byte aligned (the tiny test
//   families' odd channel counts, a GroupNorm whose groups shrank until they
//   divide C), the same kernels run a scalar path, masked at C (a VECTOR
//   template parameter of each kernel).
// - GroupNorm is two launches.  The statistics kernel cuts each sample's L
//   rows into T tiles, about four blocks an SM over the grid (T, N): lanes
//   of threads walk the tile's rows with four rows' loads in flight,
//   keeping each channel's count, mean and M2 in registers (Welford), then
//   merge lanes and channels into one (count, mean, M2) per (n, tile, group)
//   (Chan's formula) in a small f32 scratch.  The apply kernel merges its
//   sample's T partials in a fixed order, then normalises, applies the
//   affine and SiLU, and stores.  No float atomics: the same input gives the
//   same bits, launch after launch, eager or replayed from a CUDA graph.
//   Statistics never cross samples, so a padded bucket slot never touches a
//   real one.
// - LayerNorm is one launch: a warp a row, the row in registers (up to
//   C = 2048: 8 chunks of 8 a lane; the port's widest LayerNorm is 1280), an
//   exact two-pass mean and variance by warp shuffles, one read and one
//   write.
// - No shared-memory staging of the activation and no tensor cores: there
//   is nothing to reuse between threads but the statistics.
//
// The __global__ names say "norm" and nothing that the benchmark's trace
// classifies as a convolution, GEMM or copy, so the device trace counts them
// as norm/reduce (benchmark/trace.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;             // elements a thread moves at once
constexpr int UNROLL = 4;          // rows of loads in flight a thread (GroupNorm)
constexpr int BLOCKS_PER_SM = 4;   // GroupNorm's target grid
constexpr int MAX_CHANNELS = 4096; // GroupNorm: the statistics' shared memory
constexpr int ROW_CHUNKS = 8;      // LayerNorm: chunks a lane holds
constexpr int MAX_ROW = 32 * ROW_CHUNKS * 8;  // LayerNorm: the widest row (2048)
constexpr int WARPS = THREADS / 32;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Vector stores through the store intrinsics, so the compiler keeps them
// 16 bytes wide.
__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stwb(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[VEC]) {
  __stwb(reinterpret_cast<uint4*>(p), make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])));
}

// The first m (<= 8) elements at p, vector-wide where VECTOR (m is then 8);
// the rest read as 0.
template <bool VECTOR, typename T>
__device__ __forceinline__ void load_chunk(const T* p, int m, float (&v)[VEC]) {
  if (VECTOR) {
    load8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = k < m ? to_f32(p[k]) : 0.0f;
  }
}

template <bool VECTOR, typename T>
__device__ __forceinline__ void store_chunk(T* p, int m, const float (&v)[VEC]) {
  if (VECTOR) {
    store8(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < m) p[k] = from_f32<T>(v[k]);
  }
}

__device__ __forceinline__ float silu(float y) { return y * __frcp_rn(1.0f + __expf(-y)); }

// Chan's formula: fold (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.0f) return;
  const float total = n + nb;
  const float d = mb - mean;
  const float w = nb / total;
  mean += d * w;
  m2 += m2b + d * d * n * w;
  n = total;
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// GroupNorm
// ---------------------------------------------------------------------------

// A block's threads: tx walks chunks of 8 channels (bdx of them at once), ty
// the tile's rows (bdy lanes of rows).
__host__ __device__ __forceinline__ int chunks_of(int C) { return (C + VEC - 1) / VEC; }
__host__ __device__ __forceinline__ int lanes_x(int C) {
  return chunks_of(C) < THREADS ? chunks_of(C) : THREADS;
}
__host__ __device__ __forceinline__ int lanes_y(int C) { return THREADS / lanes_x(C); }

struct GroupNormArgs {
  const void* x;      // [N, L, C]
  void* y;            // [N, L, C]
  const void* scale;  // [C]
  const void* bias;   // [C]
  float4* part;       // [N, T, G]: (count, mean, M2, 0) of each tile's rows of each group
  long long L;        // rows a sample
  long long tile_rows;
  int C, G, T;
  float eps;
};

// Rows of a tile of `rows` rows that lane y of bdy takes (y, y + bdy, ...).
__device__ __forceinline__ float lane_rows(long long rows, int y, int bdy) {
  return rows > y ? (float)((rows - y + bdy - 1) / bdy) : 0.0f;
}

template <bool VECTOR, typename T>
__device__ __forceinline__ void welford_rows(const T* x, long long r, long long r1, int bdy, int C,
                                             int m, float (&mean)[VEC], float (&m2)[VEC]) {
  float n = 0.0f;
  for (; r + (UNROLL - 1) * bdy < r1; r += UNROLL * bdy) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_chunk<VECTOR>(x + (r + u * bdy) * C, m, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      n += 1.0f;
      const float inv = 1.0f / n;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = v[u][k] - mean[k];
        mean[k] += d * inv;
        m2[k] += d * (v[u][k] - mean[k]);
      }
    }
  }
  for (; r < r1; r += bdy) {
    float v[VEC];
    load_chunk<VECTOR>(x + r * C, m, v);
    n += 1.0f;
    const float inv = 1.0f / n;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = v[k] - mean[k];
      mean[k] += d * inv;
      m2[k] += d * (v[k] - mean[k]);
    }
  }
}

// Grid (T, N).  Shared memory: [2][bdy][C] floats, each lane's per-channel
// mean and M2 over its rows of the tile.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) group_norm_stats_kernel(const GroupNormArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, bdx = lanes_x(C), bdy = lanes_y(C), cc = chunks_of(C);
  const int tx = threadIdx.x % bdx, ty = threadIdx.x / bdx;
  const int t = blockIdx.x, n = blockIdx.y;
  const long long r0 = (long long)t * a.tile_rows;
  const long long r1 = r0 + a.tile_rows < a.L ? r0 + a.tile_rows : a.L;
  float* mean_s = smem;
  float* m2_s = smem + bdy * C;
  if (ty < bdy) {
    const T* x = static_cast<const T*>(a.x) + (long long)n * a.L * C;
    for (int j = tx; j < cc; j += bdx) {
      const int c0 = j * VEC, m = C - c0 < VEC ? C - c0 : VEC;
      float mean[VEC], m2[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.0f;
      welford_rows<VECTOR>(x + c0, r0 + ty, r1, bdy, C, m, mean, m2);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (k < m) {
          mean_s[ty * C + c0 + k] = mean[k];
          m2_s[ty * C + c0 + k] = m2[k];
        }
      }
    }
  }
  __syncthreads();
  // each channel: its lanes in order, into lane 0's slot
  const long long rows = r1 - r0;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float cn = lane_rows(rows, 0, bdy), cm = mean_s[c], cm2 = m2_s[c];
    for (int y = 1; y < bdy; ++y)
      chan(cn, cm, cm2, lane_rows(rows, y, bdy), mean_s[y * C + c], m2_s[y * C + c]);
    mean_s[c] = cm;
    m2_s[c] = cm2;
  }
  __syncthreads();
  // each group: its channels hold equal counts, so the mean of their means
  // and the channels' spread about it, in channel order
  const int cg = C / a.G;
  const float fr = (float)rows;
  for (int g = threadIdx.x; g < a.G; g += THREADS) {
    float s = 0.0f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) s += mean_s[c];
    const float gm = s / cg;
    float q = 0.0f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      const float d = mean_s[c] - gm;
      q += m2_s[c] + fr * d * d;
    }
    a.part[((long long)n * a.T + t) * a.G + g] = make_float4(fr * cg, gm, q, 0.0f);
  }
}

// Grid (T, N).  Shared memory: mean[G], rstd[G], then [3][THREADS] floats
// for the merge of the sample's T partials: P threads a group each fold
// tiles p, p+P, ... in order, then the group's first thread folds their P
// results in order.
template <typename T, bool VECTOR, bool SILU>
__global__ void __launch_bounds__(THREADS) group_norm_apply_kernel(const GroupNormArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, G = a.G, bdx = lanes_x(C), bdy = lanes_y(C), cc = chunks_of(C);
  const int t = blockIdx.x, n = blockIdx.y;
  float* mean_g = smem;
  float* rstd_g = smem + G;
  float* sn = smem + 2 * G;
  float* sm = sn + THREADS;
  float* sq = sm + THREADS;
  const int P = G < THREADS ? THREADS / G : 1, per_round = THREADS / P;
  const float4* part = a.part + (long long)n * a.T * G;
  for (int g0 = 0; g0 < G; g0 += per_round) {
    const int g = g0 + threadIdx.x / P, p = threadIdx.x % P;
    float pn = 0.0f, pm = 0.0f, pq = 0.0f;
    if (g < G && threadIdx.x < per_round * P) {
#pragma unroll 4
      for (int tt = p; tt < a.T; tt += P) {
        const float4 v = part[(long long)tt * G + g];
        chan(pn, pm, pq, v.x, v.y, v.z);
      }
    }
    sn[threadIdx.x] = pn;
    sm[threadIdx.x] = pm;
    sq[threadIdx.x] = pq;
    __syncthreads();
    if (g < G && p == 0 && threadIdx.x < per_round * P) {
      for (int i = 1; i < P; ++i)
        chan(pn, pm, pq, sn[threadIdx.x + i], sm[threadIdx.x + i], sq[threadIdx.x + i]);
      mean_g[g] = pm;
      rstd_g[g] = rsqrtf(pq / pn + a.eps);
    }
    __syncthreads();
  }
  const int tx = threadIdx.x % bdx, ty = threadIdx.x / bdx;
  if (ty >= bdy) return;
  const long long r0 = (long long)t * a.tile_rows;
  const long long r1 = r0 + a.tile_rows < a.L ? r0 + a.tile_rows : a.L;
  const long long base = (long long)n * a.L * C;
  const T* x = static_cast<const T*>(a.x) + base;
  T* y = static_cast<T*>(a.y) + base;
  const int cg = C / G;
  for (int j = tx; j < cc; j += bdx) {
    const int c0 = j * VEC, m = C - c0 < VEC ? C - c0 : VEC;
    float mu[VEC], mul[VEC], add[VEC];
    load_chunk<VECTOR>(static_cast<const T*>(a.scale) + c0, m, mul);
    load_chunk<VECTOR>(static_cast<const T*>(a.bias) + c0, m, add);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int g = (c0 + (k < m ? k : 0)) / cg;
      mu[k] = mean_g[g];
      mul[k] *= rstd_g[g];
    }
    long long r = r0 + ty;
    for (; r + (UNROLL - 1) * bdy < r1; r += UNROLL * bdy) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_chunk<VECTOR>(x + (r + u * bdy) * C + c0, m, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float o = (v[u][k] - mu[k]) * mul[k] + add[k];
          v[u][k] = SILU ? silu(o) : o;
        }
        store_chunk<VECTOR>(y + (r + u * bdy) * C + c0, m, v[u]);
      }
    }
    for (; r < r1; r += bdy) {
      float v[VEC];
      load_chunk<VECTOR>(x + r * C + c0, m, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float o = (v[k] - mu[k]) * mul[k] + add[k];
        v[k] = SILU ? silu(o) : o;
      }
      store_chunk<VECTOR>(y + r * C + c0, m, v);
    }
  }
}

size_t stats_smem(int C) { return (size_t)2 * lanes_y(C) * C * sizeof(float); }
size_t apply_smem(int G) { return (size_t)(2 * G + 3 * THREADS) * sizeof(float); }

template <typename T, bool VECTOR>
cudaError_t group_norm_launch(const GroupNormArgs& a, int N, bool act, cudaStream_t stream) {
  const dim3 grid(a.T, N);
  group_norm_stats_kernel<T, VECTOR><<<grid, THREADS, stats_smem(a.C), stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (act)
    group_norm_apply_kernel<T, VECTOR, true><<<grid, THREADS, apply_smem(a.G), stream>>>(a);
  else
    group_norm_apply_kernel<T, VECTOR, false><<<grid, THREADS, apply_smem(a.G), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t group_norm_dispatch(const GroupNormArgs& a, int N, bool vector, bool act,
                                cudaStream_t stream) {
  return vector ? group_norm_launch<T, true>(a, N, act, stream)
                : group_norm_launch<T, false>(a, N, act, stream);
}

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

struct LayerNormArgs {
  const void* x;      // [R, C]
  void* y;            // [R, C]
  const void* scale;  // [C]
  const void* bias;   // [C]
  long long R;
  int C;
  float eps;
};

// A warp a row, K chunks of 8 a lane (chunk lane + 32k), the row held in
// registers; VECTOR as for GroupNorm (off it, each chunk masked at C).
template <typename T, int K, bool VECTOR>
__global__ void __launch_bounds__(THREADS) layer_norm_rows_kernel(const LayerNormArgs a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= a.R) return;
  const int C = a.C, cc = chunks_of(C);
  const T* x = static_cast<const T*>(a.x) + row * C;
  T* y = static_cast<T*>(a.y) + row * C;
  float v[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k, c0 = j * VEC;
    if (j < cc) {
      load_chunk<VECTOR>(x + c0, C - c0 < VEC ? C - c0 : VEC, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[k][e];
  const float mean = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (lane + 32 * k) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (c0 + e < C) {
        const float d = v[k][e] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + a.eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k, c0 = j * VEC, m = C - c0 < VEC ? C - c0 : VEC;
    if (j < cc) {
      float mul[VEC], add[VEC];
      load_chunk<VECTOR>(static_cast<const T*>(a.scale) + c0, m, mul);
      load_chunk<VECTOR>(static_cast<const T*>(a.bias) + c0, m, add);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = (v[k][e] - mean) * rstd * mul[e] + add[e];
      store_chunk<VECTOR>(y + c0, m, v[k]);
    }
  }
}

template <typename T, int K>
cudaError_t layer_norm_launch(const LayerNormArgs& a, bool vector, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.R + WARPS - 1) / WARPS);
  if (vector)
    layer_norm_rows_kernel<T, K, true><<<blocks, THREADS, 0, stream>>>(a);
  else
    layer_norm_rows_kernel<T, K, false><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t layer_norm_dispatch(const LayerNormArgs& a, bool vector, cudaStream_t stream) {
  switch ((chunks_of(a.C) + 31) / 32) {
    case 1: return layer_norm_launch<T, 1>(a, vector, stream);
    case 2: return layer_norm_launch<T, 2>(a, vector, stream);
    case 3: return layer_norm_launch<T, 3>(a, vector, stream);
    case 4: return layer_norm_launch<T, 4>(a, vector, stream);
    case 5: return layer_norm_launch<T, 5>(a, vector, stream);
    case 6: return layer_norm_launch<T, 6>(a, vector, stream);
    case 7: return layer_norm_launch<T, 7>(a, vector, stream);
    case 8: return layer_norm_launch<T, 8>(a, vector, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool vector_ok(int C, const void* x, const void* y, const void* scale, const void* bias) {
  return C % VEC == 0 && aligned16(x) && aligned16(y) && aligned16(scale) && aligned16(bias);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Tiles a sample's L rows are cut into for GroupNorm on the current device:
// about BLOCKS_PER_SM blocks an SM over the (T, N) grid, each lane of a tile
// taking at least UNROLL rows.  The wrapper sizes the [N, T, G] scratch by it.
// Returns T >= 1, or minus a cudaError_t.
extern "C" int group_norm_tiles(int N, long long L, int C) {
  if (N <= 0 || L <= 0 || C <= 0) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  long long t = ceil_div((long long)BLOCKS_PER_SM * sms, N);
  const long long most = ceil_div(L, (long long)UNROLL * lanes_y(C));
  t = t < most ? t : most;
  t = t < 1 ? 1 : t;
  t = ceil_div(L, ceil_div(L, t));  // no empty tile
  return t > 65535 ? 65535 : (int)t;
}

// x, y: [N, L, C] contiguous; scale, bias: [C], all of one type (dtype:
// 0 f32, 1 bf16); part: [N, T, G] float4 of scratch (T from
// group_norm_tiles).  act: 1 applies SiLU after the affine.  Two launches
// on `stream`.  Returns the cudaError_t of the launches (0 = ok).
extern "C" int group_norm_forward(const void* x, void* y, const void* scale, const void* bias,
                                  void* part, int dtype, int N, long long L, int C, int G, int T,
                                  float eps, int act, void* stream_ptr) {
  if ((dtype != F32 && dtype != BF16) || N <= 0 || N > 65535 || L <= 0 || C <= 0 ||
      C > MAX_CHANNELS || G <= 0 || C % G != 0 || T <= 0 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const long long tile_rows = ceil_div(L, T);
  const GroupNormArgs a{x, y, scale, bias, static_cast<float4*>(part), L, tile_rows,
                        C, G, (int)ceil_div(L, tile_rows), eps};
  const bool vector = vector_ok(C, x, y, scale, bias);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == F32) return (int)group_norm_dispatch<float>(a, N, vector, act, stream);
  return (int)group_norm_dispatch<bf16>(a, N, vector, act, stream);
}

// x, y: [R, C] contiguous, C <= MAX_ROW; scale, bias: [C]; all of one type
// (dtype: 0 f32, 1 bf16).  One launch on `stream`.
extern "C" int layer_norm_forward(const void* x, void* y, const void* scale, const void* bias,
                                  int dtype, long long R, int C, float eps, void* stream_ptr) {
  if ((dtype != F32 && dtype != BF16) || R <= 0 || R > 0x7fffffffLL || C <= 0 || C > MAX_ROW)
    return (int)cudaErrorInvalidValue;
  const LayerNormArgs a{x, y, scale, bias, R, C, eps};
  const bool vector = vector_ok(C, x, y, scale, bias);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == F32) return (int)layer_norm_dispatch<float>(a, vector, stream);
  return (int)layer_norm_dispatch<bf16>(a, vector, stream);
}

extern "C" const char* fused_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
