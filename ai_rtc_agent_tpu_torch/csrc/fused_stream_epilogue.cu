// Fused stream-step epilogue for Hopper (sm_90a): plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel ai_rtc_agent_tpu/ops/pallas/fused_scheduler.py
// (fused_stream_epilogue / _kernel): after the UNet returns eps_c, the whole
// post-UNet chain of one stream step over [B, h, w, c] latents, per batch
// row b with f32 coefficient vectors alpha, sigma, c_skip, c_out,
// next_alpha, next_sigma and the scalars g (guidance) and delta:
//
//   eps    = g*eps_c - (g-1)*delta*stock        (cfg self/initialize; else eps_c)
//   x0     = (x - sigma*eps) / alpha
//   den    = c_skip*x + c_out*x0                (turbo: den = x0, c_skip=0, c_out=1)
//   adv    = next_alpha*den + next_sigma*noise[b + shift]   (noise 0 past the last row)
//   stock' = (eps_c + beta*stock) / (1+beta),  beta = sigma / max(alpha, 1e-6)  (cfg self)
//
// Math is f32; loads and stores use the tensors' type (bf16 or f32).
//
// What bounds it on the main path (sd-turbo: turbo, cfg none, B=1, one
// [1,64,64,4] bf16 latent): about ten flops per element over ~96 KB (x and
// eps in, den out; with the renoise shift of one row there is no noise row
// to read and no advanced row to keep), a 0.03 us transfer at 3.35 TB/s.
// The launch bounds it, not bytes and not arithmetic: an empty kernel on
// the same grid takes most of the time (chip_smoke.py phase 3 prints both).
// So the design is the shortest launch that does the work in one pass, and
// what is left above the floor is one memory round trip:
// - Each thread owns 8 contiguous elements and moves them with 16-byte
//   vector loads and stores (one per tensor in bf16, two in f32).  A scalar
//   path, out of line, covers the ragged tail and any row whose base is not
//   16-byte aligned (n not a multiple of 8, or an offset tensor).
// - The vector path is one basic block: every load (data and coefficients)
//   issues before any arithmetic waits on one.  The row's divisors become
//   reciprocals from the fast reciprocal, taken after the loads; nothing
//   divides per element.
// - Grid (ceil(n / (8*128)), B) of 128-thread blocks: 16 blocks at B=1 and
//   64 at B=4 for a 64x64x4 latent, one wave on 132 SMs.  256-thread blocks
//   were slower at B=4 on the card (half the SMs, each moving twice the
//   bytes); 64-thread ones were no faster.  Each block reads its row's
//   coefficients straight from the engine's f32 device vectors and the
//   guidance/delta device scalars, by pointer: nothing is staged on the
//   host, so the launch can be captured in a CUDA graph.
// - No shared memory and no tensor cores: an elementwise pass at ten flops
//   per element gives them nothing to do.
// - The whole chain is this one launch: turbo coefficients are implied
//   (TURBO), the renoise shift is an index, and the advanced rows and the
//   new stock may be written in place (into the engine's ring buffer and
//   stock).  Every element is read and written by the same thread, loads
//   before stores, and no pointer is __restrict__: x and stock may alias
//   the advanced rows and the new stock.
// Where the stock does not change (cfg none/initialize) it is not written;
// with cfg none it is not read either.
//
// The session axis (a bucket step of k sessions, the JAX kernel under
// jax.vmap over sessions): the R = k*seg rows come in segments of seg rows,
// one per session.  Segment s is session slot idx[s] (s itself without an
// idx vector) of the stacked [S, ...] state: its coefficients, guidance and
// delta, stock and noise rows are read at that slot, entry r renoises with
// the slot's noise row r + shift, and its advanced rows and new stock are
// written into that slot's rows in place.  A bucket padded with duplicate
// slots (the tail repeats the last real one) writes only its first k_real
// segments, so no slot is written twice; a padding segment may read a row
// its twin has already written, and its outputs are discarded.  Each element
// is still read and then written by one thread.  One segment with no idx
// vector is the kernel as the single-session step calls it.
//
// k_real comes by value or from device memory (k_real_dev, one int32).  A
// CUDA graph replays its launches with the arguments they were captured
// with, so a bucket step captured once serves every occupancy of its
// bucket only if the count is data: each block reads it once, like idx.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 8;  // elements per thread

enum Cfg { CFG_NONE = 0, CFG_INITIALIZE = 1, CFG_SELF = 2 };
enum DType { F32 = 0, BF16 = 1 };

struct Args {
  const void* x;
  const void* eps;
  const void* stock;
  const void* noise;
  void* den;
  void* adv;        // rows b < adv_rows
  void* stock_out;  // cfg self only; may be stock itself
  const float* alpha;
  const float* sigma;
  const float* c_skip;  // unread with TURBO
  const float* c_out;   // unread with TURBO
  const float* next_alpha;
  const float* next_sigma;
  const float* guidance;  // one f32 per slot
  const float* delta;     // one f32 per slot
  const int* idx;         // segment -> slot; null: segment s is slot s
  const int* k_real_dev;  // the count of writing segments; null: k_real
  long long n;            // elements per row
  int seg;                // rows per segment (session)
  int k_real;             // segments that write adv and stock_out (no k_real_dev)
  int noise_rows;   // noise rows per slot
  int noise_shift;  // entry r renoises with the slot's noise row r + noise_shift
  int adv_rows;     // adv rows per slot (entries r < adv_rows are kept)
};

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

// Stores go through the vector store intrinsics: a plain uint4 assignment
// was split into four 32-bit stores by the compiler.
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

// One row's coefficients as read from device memory, once by each thread.
struct Raw {
  float alpha, sigma, c_skip, c_out, next_alpha, next_sigma, g, delta;
};

// Coefficient vectors are [S, seg] (entry `at` = slot*seg + r); guidance
// and delta are [S].
template <int CFG, bool TURBO>
__device__ __forceinline__ Raw load_coef(const Args& a, long long at, int slot) {
  Raw r;
  r.alpha = a.alpha[at];
  r.sigma = a.sigma[at];
  r.c_skip = TURBO ? 0.0f : a.c_skip[at];
  r.c_out = TURBO ? 1.0f : a.c_out[at];
  r.next_alpha = a.next_alpha[at];
  r.next_sigma = a.next_sigma[at];
  r.g = CFG != CFG_NONE ? a.guidance[slot] : 1.0f;
  r.delta = CFG != CFG_NONE ? a.delta[slot] : 0.0f;
  return r;
}

// What the element math uses: the row's two divisors as reciprocals, so no
// element divides.  They come from the fast reciprocal (__fdividef: MUFU.RCP
// and a multiply, within 2 ulp in f32, far inside a bf16 output's rounding)
// because an IEEE division branches to a slow path: the compiler hoisted
// those branches above the data loads, which then waited on the coefficient
// loads (a second memory round trip), and the calls kept the stores from
// being vectorised.
struct Coef {
  float inv_alpha, sigma, c_skip, c_out, next_alpha, next_sigma, g, gm1d, beta, inv_1pbeta;
};

template <int CFG>
__device__ __forceinline__ Coef derive(const Raw& r) {
  Coef c;
  c.inv_alpha = __fdividef(1.0f, r.alpha);
  c.sigma = r.sigma;
  c.c_skip = r.c_skip;
  c.c_out = r.c_out;
  c.next_alpha = r.next_alpha;
  c.next_sigma = r.next_sigma;
  c.g = r.g;
  c.gm1d = (r.g - 1.0f) * r.delta;
  c.beta = CFG == CFG_SELF ? __fdividef(r.sigma, fmaxf(r.alpha, 1e-6f)) : 0.0f;
  c.inv_1pbeta = CFG == CFG_SELF ? __fdividef(1.0f, 1.0f + c.beta) : 0.0f;
  return c;
}

template <int CFG, bool TURBO>
__device__ __forceinline__ void element(const Coef& c, float x, float eps_c, float stock,
                                        float noise, float& den, float& adv, float& new_stock) {
  const float eps = CFG != CFG_NONE ? c.g * eps_c - c.gm1d * stock : eps_c;
  const float x0 = (x - c.sigma * eps) * c.inv_alpha;
  den = TURBO ? x0 : c.c_skip * x + c.c_out * x0;
  adv = c.next_alpha * den + c.next_sigma * noise;
  if (CFG == CFG_SELF) new_stock = (eps_c + c.beta * stock) * c.inv_1pbeta;
}

// One row's pointers at element i0: row = s*seg + r is entry r of segment
// s, which is slot `slot` of the stacked state.  x, eps and den are [R, n];
// stock and stock_out [S, seg, n], noise [S, noise_rows, n], adv
// [S, adv_rows, n].  noise is null past the slot's last noise row; adv is
// kept for entries r < adv_rows of the first k_real segments, and the new
// stock for those segments only.
template <typename T>
struct Row {
  const T *x, *eps, *stock, *noise;
  T *den, *adv, *stock_out;
  long long coef;  // the entry's index in the [S, seg] coefficient vectors
  int slot;
  bool keep_adv, write;

  __device__ __forceinline__ Row(const Args& a, int row, long long i0) {
    const int s = row / a.seg, r = row - s * a.seg;
    slot = a.idx ? a.idx[s] : s;
    write = s < (a.k_real_dev ? *a.k_real_dev : a.k_real);
    coef = (long long)slot * a.seg + r;
    const long long base = (long long)row * a.n + i0;
    const long long stock_base = coef * a.n + i0;
    x = static_cast<const T*>(a.x) + base;
    eps = static_cast<const T*>(a.eps) + base;
    den = static_cast<T*>(a.den) + base;
    stock = static_cast<const T*>(a.stock) + stock_base;
    stock_out = static_cast<T*>(a.stock_out) + stock_base;
    adv = static_cast<T*>(a.adv) + ((long long)slot * a.adv_rows + r) * a.n + i0;
    const int noise_row = r + a.noise_shift;
    keep_adv = write && r < a.adv_rows;
    noise = keep_adv && noise_row < a.noise_rows
                ? static_cast<const T*>(a.noise) +
                      ((long long)slot * a.noise_rows + noise_row) * a.n + i0
                : nullptr;
  }
};

// The ragged tail, or a row whose base is not 16-byte aligned: element by
// element.  Out of line, so that the vector path stays one basic block in
// which every load issues before any arithmetic waits.
template <typename T, int CFG, bool TURBO>
__device__ __noinline__ void scalar_path(const Args a, int row, long long i0) {
  constexpr bool READ_STOCK = CFG != CFG_NONE;
  const Row<T> r(a, row, i0);
  const Coef c = derive<CFG>(load_coef<CFG, TURBO>(a, r.coef, r.slot));
  const int m = a.n - i0 < VEC ? (int)(a.n - i0) : VEC;
  for (int k = 0; k < m; ++k) {
    const float s = READ_STOCK ? to_f32(r.stock[k]) : 0.0f;
    const float nz = r.noise ? to_f32(r.noise[k]) : 0.0f;
    float d, v, t;
    element<CFG, TURBO>(c, to_f32(r.x[k]), to_f32(r.eps[k]), s, nz, d, v, t);
    r.den[k] = from_f32<T>(d);
    if (r.keep_adv) r.adv[k] = from_f32<T>(v);
    if (CFG == CFG_SELF && r.write) r.stock_out[k] = from_f32<T>(t);
  }
}

template <typename T, int CFG, bool TURBO>
__global__ void __launch_bounds__(THREADS) stream_epilogue_kernel(const Args a) {
  constexpr bool READ_STOCK = CFG != CFG_NONE;
  constexpr bool SELF = CFG == CFG_SELF;
  const int row = blockIdx.y;
  const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i0 >= a.n) return;
  const Row<T> r(a, row, i0);
  uintptr_t bits = reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.eps) |
                   reinterpret_cast<uintptr_t>(r.den);
  if (READ_STOCK) bits |= reinterpret_cast<uintptr_t>(r.stock);
  if (SELF && r.write) bits |= reinterpret_cast<uintptr_t>(r.stock_out);
  if (r.noise) bits |= reinterpret_cast<uintptr_t>(r.noise);
  if (r.keep_adv) bits |= reinterpret_cast<uintptr_t>(r.adv);
  if ((bits & 15) != 0 || i0 + VEC > a.n) {
    scalar_path<T, CFG, TURBO>(a, row, i0);
    return;
  }

  const Raw raw = load_coef<CFG, TURBO>(a, r.coef, r.slot);
  float vx[VEC], ve[VEC], vs[VEC], vn[VEC], vd[VEC], va[VEC], vt[VEC];
  load8(r.x, vx);
  load8(r.eps, ve);
  if (READ_STOCK) load8(r.stock, vs);
  if (r.noise) {
    load8(r.noise, vn);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) vn[k] = 0.0f;
  }
  const Coef c = derive<CFG>(raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    element<CFG, TURBO>(c, vx[k], ve[k], READ_STOCK ? vs[k] : 0.0f, vn[k], vd[k], va[k], vt[k]);
  store8(r.den, vd);
  if (r.keep_adv) store8(r.adv, va);
  if (SELF && r.write) store8(r.stock_out, vt);
}

__global__ void empty_kernel() {}

constexpr long long BLOCK_ELEMS = (long long)THREADS * VEC;

dim3 grid_of(int B, long long n) {
  return dim3((unsigned)((n + BLOCK_ELEMS - 1) / BLOCK_ELEMS), (unsigned)B);
}

bool valid_grid(int B, long long n) {
  return B > 0 && B <= 65535 && n > 0 && (n + BLOCK_ELEMS - 1) / BLOCK_ELEMS <= 0x7fffffffLL;
}

template <typename T, int CFG, bool TURBO>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  stream_epilogue_kernel<T, CFG, TURBO><<<grid_of(B, a.n), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int cfg, int turbo, int B, cudaStream_t stream) {
  switch (cfg * 2 + (turbo ? 1 : 0)) {
    case CFG_NONE * 2: return launch<T, CFG_NONE, false>(a, B, stream);
    case CFG_NONE * 2 + 1: return launch<T, CFG_NONE, true>(a, B, stream);
    case CFG_INITIALIZE * 2: return launch<T, CFG_INITIALIZE, false>(a, B, stream);
    case CFG_INITIALIZE * 2 + 1: return launch<T, CFG_INITIALIZE, true>(a, B, stream);
    case CFG_SELF * 2: return launch<T, CFG_SELF, false>(a, B, stream);
    case CFG_SELF * 2 + 1: return launch<T, CFG_SELF, true>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, eps, den: [B, n], B = k*seg rows in k segments of seg rows.  Segment s
// is slot idx[s] (s when idx is null) of the stacked state: stock and
// stock_out [S, seg, n] (cfg self; stock_out may be stock), noise
// [S, noise_rows, n], adv [S, adv_rows, n], coefficient vectors [S, seg]
// f32 device pointers (c_skip/c_out unread with turbo), guidance and delta
// [S] f32.  adv and stock_out are written for the first k_real segments
// only, where k_real is *k_real_dev when that pointer is not null.  One
// segment with idx null (seg = B, k_real = 1) is the single-session call.
// dtype: 0 f32, 1 bf16.  cfg: 0 none, 1 initialize, 2 self.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int fused_stream_epilogue(const void* x, const void* eps, const void* stock,
                                     const void* noise, void* den, void* adv, void* stock_out,
                                     const float* alpha, const float* sigma,
                                     const float* c_skip, const float* c_out,
                                     const float* next_alpha, const float* next_sigma,
                                     const float* guidance, const float* delta, const int* idx,
                                     const int* k_real_dev, int dtype, int cfg, int turbo, int B,
                                     long long n, int seg, int k_real, int noise_rows,
                                     int noise_shift, int adv_rows, void* stream_ptr) {
  if (!valid_grid(B, n) || seg <= 0 || B % seg != 0 || k_real < 0 || k_real > B / seg ||
      noise_rows < 0 || noise_shift < 0 || adv_rows < 0 || adv_rows > seg || cfg < CFG_NONE ||
      cfg > CFG_SELF)
    return (int)cudaErrorInvalidValue;
  const Args a{x,          eps,      stock, noise, den,        adv,
               stock_out,  alpha,    sigma, c_skip, c_out,     next_alpha,
               next_sigma, guidance, delta, idx,   k_real_dev, n,
               seg,        k_real,   noise_rows,   noise_shift, adv_rows};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == F32) return (int)dispatch<float>(a, cfg, turbo, B, stream);
  if (dtype == BF16) return (int)dispatch<bf16>(a, cfg, turbo, B, stream);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel launched on the epilogue's grid for B rows of n
// elements: the launch floor the epilogue is timed against.
extern "C" int fused_stream_epilogue_empty(int B, long long n, void* stream_ptr) {
  if (!valid_grid(B, n)) return (int)cudaErrorInvalidValue;
  empty_kernel<<<grid_of(B, n), THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* fused_stream_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
