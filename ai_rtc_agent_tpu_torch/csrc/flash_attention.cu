// Flash attention forward for Hopper (sm_90a): TMA + wgmma, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel ai_rtc_agent_tpu/ops/pallas/attention.py
// (flash_attention / _attn_kernel): non-causal, unmasked
// softmax(Q K^T / sqrt(D)) V over q [B,Lq,H,D], k/v [B,Lk,H,D], with the
// running max and denominator in f32; bf16 in and out.
//
// What bounds it on the main path (sd-turbo 512^2, D=64, 32 launches a
// step): the self-attention at 4096 tokens (H5) and 1024 tokens (H10) does
// 4*Lq*Lk*D*H flops on ~8*L*H*D bytes, far above the card's ~295 flop/byte
// ridge, so tensor-core throughput bounds it.  The 77-token
// cross-attention and the 256- and 64-token levels are one or a few key
// tiles per block and 20-160 blocks: launch and latency bound them (the
// serial chain TMA -> wgmma -> softmax -> wgmma -> store of one tile).
//
// Design:
// - TMA loads Q, K and V straight from [B,L,H,D]: one tensor map per
//   operand over dims (D, H, L, B), byte strides (2, 2D, 2HD, 2LHD), a box
//   of (64, 1, rows, 1) with the 128-byte swizzle.  The D tail (D = 40, 80,
//   160) and the Lq/Lk tails arrive as zeros (out-of-bounds fill), so there
//   is no transpose and no padding copy.  The maps are encoded on the host
//   in C for every launch (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__.
// - A ring of STAGES K/V tiles with full/empty mbarriers.  The last
//   warpgroup of the block is the producer: it gives its registers away
//   (setmaxnreg.dec to 24) and one of its threads issues every TMA load,
//   refilling a stage once each consumer warp has released it.  The
//   consumer warpgroups take the registers (setmaxnreg.inc) and each owns
//   64 query rows.
// - S = Q K^T is an SS wgmma (Q and K both K-major).  The online softmax
//   runs on the f32 accumulator fragment in registers, in the log2 domain
//   with the scale folded into one FMA; a row lies on a quad of lanes, so
//   its max and sum take two shuffles.  The Lk tail is set to -inf before
//   the max.  P goes to bf16 pairs in registers and is the A operand of an
//   RS wgmma for O += P V (V is [BK][D], D contiguous: MN-major, transpose
//   bit).  O is rescaled in registers; nothing returns to shared memory
//   inside the key loop.
// - Epilogue: O / l to bf16 straight from the fragment to device memory;
//   the Lq and D tails are not stored.
//
// Instantiations (DP = D padded to 64-column blocks; BQ = 64 x consumer
// warpgroups; registers: launch count from __launch_bounds__, then
// producer / consumer after setmaxnreg; shared memory = Q + STAGES x (K+V)):
//   Wide64    D <= 64, Lq >= 2048: BQ 192 (3 consumer WGs), BK 128, 4 stages,
//             512 threads, 1 block/SM: 128 -> 24 / 160 regs
//             (128*24 + 384*160 = 64,512 of 65,536); 24 + 4*32 KB = 152 KB.
//   Narrow64  D <= 64, Lq < 2048: BQ 64, BK 128, 2 stages, 256 threads,
//             2 blocks/SM: 128 -> 24 / 128 regs; 8 + 2*32 KB = 72 KB.
//   Narrow128 64 < D <= 128: BQ 64, BK 64, 2 stages, 2 blocks/SM:
//             128 -> 24 / 128 regs; 16 + 2*32 KB = 80 KB.
//   Narrow192 128 < D <= 160: BQ 64, BK 64, 2 stages, 1 block/SM:
//             240 -> 24 / 240 regs (O alone is 96 f32); 24 + 2*48 KB = 120 KB.
// A consumer thread holds S (BK/2 f32), P (BK/4 packed bf16 pairs), O
// (DP/2 f32) and its two rows' max and sum.
//
// Wave arithmetic on 132 SMs (main path):
//   4096^2 H5 and 4096x77 H5: ceil(4096/192) x 5 = 110 blocks, one wave at
//     one block per SM (22 SMs idle).  BQ 128 (160 blocks, 1.2 waves) and
//     BQ 64 (320 blocks at 2 per SM, 1.2 waves) were slower on the card:
//     the 3-warpgroup block reuses each K/V tile for 192 rows and keeps 4
//     tiles in flight.
//   1024^2 H10 and 1024x77: 16 x 10 = 160 blocks, all resident at 2 per SM.
//   256-token H20: 80 blocks; 64-token H20: 20 blocks (latency-bound).
// BK 128 makes every 77-token cross-attention one key tile.  Wide64 with
// BK 64 was slower at 4096^2 (twice the barrier round trips per key).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WG = 128;            // threads in a warpgroup; each consumer warpgroup owns 64 query rows
constexpr int PRODUCER_REGS = 24;  // what the producer warpgroup keeps after setmaxnreg

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// outlasts ~2^34 cycles (seconds) is a deadlock: trap, so that the launch
// fails loudly instead of hanging the process.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(row),
        "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// that is still in flight (the asm below reads and writes the registers
// asynchronously, which the compiler cannot see).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms of 1024 bytes (SBO).
// K-major operands ignore LBO (1); MN-major ones take the distance between
// 64-element column blocks.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One instantiation.  DP: head dim padded to 64-column (128-byte) blocks;
// BK: key rows per tile; STAGES: K/V tiles in the ring; NWG: consumer
// warpgroups, 64 query rows each; MINB: blocks per SM for
// __launch_bounds__; CREGS: registers per consumer thread after setmaxnreg.
template <int DP_, int BK_, int STAGES_, int NWG_, int MINB_, int CREGS_>
struct Config {
  static constexpr int DP = DP_, BK = BK_, STAGES = STAGES_, NWG = NWG_, MINB = MINB_,
                       CREGS = CREGS_;
  static constexpr int BQ = 64 * NWG;               // query rows per block
  static constexpr int THREADS = WG * (NWG + 1);    // + the producer warpgroup
  static constexpr int CB = DP / 64;                // column blocks of the head dim
  static constexpr int Q_BYTES = CB * BQ * 128;     // one Q tile
  static constexpr int KV_BYTES = CB * BK * 128;    // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr size_t SMEM = Q_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1) + 1024;
};

// One key tile for the 64 query rows of this warpgroup: S = Q K^T (SS
// wgmma), online softmax on the accumulator fragment, O += P V (RS wgmma).
// sq: this warpgroup's rows of the Q tile, q_block: bytes between Q's
// column blocks.  Fragment layout of the f32 accumulator (thread t of the
// warpgroup, warp w = t/32, lane): element i is row 16w + lane/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2, so each row lies on a
// quad of lanes.  Elements 8k..8k+7 of S, packed in pairs to bf16, are
// exactly the four A registers of the k-th 16-deep step of an RS wgmma
// (PTX ISA: wgmma register fragments for a .bf16 A and the m64nNk16 f32
// D), so P feeds P V without leaving registers.
template <int DP, int BK>
__device__ __forceinline__ void attend_tile(uint32_t sq, uint32_t q_block, uint32_t sk,
                                            uint32_t sv, int kvalid, float scale_log2,
                                            float (&o)[DP / 64][32], float (&m)[2],
                                            float (&l)[2]) {
  constexpr int CB = DP / 64;
  const int lane = threadIdx.x % 32;
  float s[BK / 2];

  // S = Q K^T: Q and K both K-major (D contiguous); one 16-deep step per 32
  // bytes of the swizzled 128-byte rows
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = smem_desc(sq + (kk / 4) * q_block + col, 16);
    const uint64_t db = smem_desc(sk + (kk / 4) * BK * 128 + col, 16);
    if constexpr (BK == 128) {
      wgmma_ss_n128(s, da, db, kk > 0);
    } else {
      wgmma_ss_n64(s, da, db, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);

  if (kvalid < BK) {  // the Lk tail: TMA filled those keys with zeros
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if ((i / 4) * 8 + 2 * (lane % 4) + i % 2 >= kvalid) s[i] = -INFINITY;
  }

  // online softmax, log2 domain, the scale folded into one FMA
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = ex2(m[r] - m_new);  // 0 on the first tile (m = -inf)
    m[r] = m_new;
    l[r] *= corr[r];
  }
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int k = 0; k < BK / 16; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * k + 2 * j;
      const int r = j % 2;
      const float p0 = ex2(fmaf(s[i], scale_log2, -m[r]));
      const float p1 = ex2(fmaf(s[i + 1], scale_log2, -m[r]));
      l[r] += p0 + p1;  // this thread's columns only; the quad is summed at the end
      pa[k][j] = pack_bf16(p0, p1);
    }
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i / 2) % 2];

  // O += P V: V is [BK][D] with D contiguous, i.e. MN-major (transpose
  // bit); one 16-key step per 2 KB of V
#pragma unroll
  for (int c = 0; c < CB; ++c) fence_regs(o[c]);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_rs_n64(o[c], pa[k], smem_desc(sv + c * BK * 128 + k * 16 * 128, BK * 128));
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int c = 0; c < CB; ++c) fence_regs(o[c]);
  fence_regs(pa);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                       int Lq, int Lk, int H, int D, float scale_log2) {
  constexpr int CB = C::CB, BK = C::BK, STAGES = C::STAGES, BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // 128B swizzle wants 1024B
  const uint32_t ring = sq + C::Q_BYTES;  // stage s: K at ring + s * STAGE_BYTES, then V
  const uint32_t bar_q = ring + STAGES * C::STAGE_BYTES;
  const uint32_t full = bar_q + 8;           // full[s] at full + 8s
  const uint32_t empty = full + 8 * STAGES;  // empty[s] at empty + 8s

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / WG;  // consumer warpgroups first (wgmma wants them aligned), producer last
  const int lane = tid % 32;
  const int nkt = (Lk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);                 // the producer's expect_tx arrival
      mbar_init(empty + 8 * st, C::NWG * WG / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One branch per role for the whole kernel, so that setmaxnreg holds.
  if (wg == C::NWG) {
    // producer: one lane issues every TMA load; a stage is refilled once
    // every consumer warp has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == C::NWG * WG) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < CB; ++c) tma_load(sq + c * BQ * 128, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % STAGES;
        // the release of this stage's previous tile; parity 1 passes at once
        // on the first round (phase 0 is still open)
        mbar_wait(empty + 8 * st, ((kt / STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t sk = ring + st * C::STAGE_BYTES;
        mbar_expect_tx(bar, C::STAGE_BYTES);
        for (int c = 0; c < CB; ++c) {
          tma_load(sk + c * BK * 128, &tm_k, bar, 64 * c, h, kt * BK, b);
          tma_load(sk + C::KV_BYTES + c * BK * 128, &tm_v, bar, 64 * c, h, kt * BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CREGS));
    float o[CB][32];
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    const uint32_t sq_wg = sq + wg * 64 * 128;  // this warpgroup's 64 rows of each Q block

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int st = kt % STAGES;
      mbar_wait(full + 8 * st, (kt / STAGES) & 1);
      const uint32_t sk = ring + st * C::STAGE_BYTES;
      attend_tile<C::DP, BK>(sq_wg, BQ * 128, sk, sk + C::KV_BYTES, min(BK, Lk - kt * BK),
                             scale_log2, o, m, l);
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp's wgmmas on the stage are done
    }

    // O / l, straight from the fragment to device memory; the Lq and D
    // tails are not stored
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    const size_t row_stride = (size_t)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + tid / 32 * 16 + lane / 4 + 8 * r;  // warp w of the block: rows 16w..
      if (row >= Lq) continue;
      bf16* dst = out + ((size_t)b * Lq + row) * row_stride + (size_t)h * D;
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * (lane % 4);
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
                o[c][4 * j + 2 * r] * inv[r], o[c][4 * j + 2 * r + 1] * inv[r]);
        }
    }
  }
}

// ---- host side ----

typedef decltype(&cuTensorMapEncodeTiled) EncodeTiled;

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &status);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &status);
#endif
    if (e != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One map over a [B, L, H, D] bf16 tensor as dims (D, H, L, B); a box is
// 64 columns of one head for `rows` tokens, 128-byte swizzled; what lies
// past D or L reads as zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int L, int H, int D, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * L};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// Per device: the shared-memory attribute is set, and the register plan is
// checked against the count the kernel is launched with.  setmaxnreg.inc
// waits until the block's pool has the registers, so a plan the pool
// cannot meet would hang the launch: refuse it instead.
template <class C>
cudaError_t prepare(int* regs) {
  static bool checked[MAX_DEVICES] = {};
  static int launch_regs[MAX_DEVICES] = {};
  static cudaError_t status[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!checked[dev]) {
    auto kernel = flash_attention_kernel<C>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) {
      launch_regs[dev] = attr.numRegs;
      if (attr.numRegs < PRODUCER_REGS || attr.numRegs > C::CREGS ||
          C::THREADS * attr.numRegs < WG * PRODUCER_REGS + C::NWG * WG * C::CREGS)
        e = cudaErrorLaunchOutOfResources;
    }
    status[dev] = e;
    checked[dev] = true;
  }
  if (regs) *regs = launch_regs[dev];
  return status[dev];
}

template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
                   int H, int D, float scale, cudaStream_t stream) {
  cudaError_t e = prepare<C>(nullptr);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, B, Lq, H, D, C::BQ) || !encode(&mk, k, B, Lk, H, D, C::BK) ||
      !encode(&mv, v, B, Lk, H, D, C::BK))
    return cudaErrorInvalidValue;
  const dim3 grid((Lq + C::BQ - 1) / C::BQ, H, B);
  flash_attention_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), Lq, Lk, H, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

constexpr int WIDE_MIN_LQ = 2048;  // query rows from which Wide64 serves D <= 64
using Wide64 = Config<64, 128, 4, 3, 1, 160>;
using Narrow64 = Config<64, 128, 2, 1, 2, 128>;
using Narrow128 = Config<128, 64, 2, 1, 2, 128>;
using Narrow192 = Config<192, 64, 2, 1, 1, 240>;

bool valid_head_dim(int D) { return D > 0 && D % 8 == 0 && D <= 160; }

// Call f with the instantiation that serves head dim D at Lq query rows.
template <class F>
int with_config(int D, int Lq, F f) {
  if (D <= 64) return Lq >= WIDE_MIN_LQ ? f(Wide64{}) : f(Narrow64{});
  if (D <= 128) return f(Narrow128{});
  return f(Narrow192{});
}

}  // namespace

// Key-tile rows of the instantiation that serves head dim D at Lq query
// rows (0 if none).
extern "C" int flash_attention_key_tile(int D, int Lq) {
  if (!valid_head_dim(D)) return 0;
  return with_config(D, Lq, [](auto c) { return decltype(c)::BK; });
}

// Registers per thread the instantiation for (D, Lq) is launched with;
// negated if its register plan cannot run with that many (the launch
// refuses it).
extern "C" int flash_attention_registers(int D, int Lq) {
  if (!valid_head_dim(D)) return 0;
  return with_config(D, Lq, [](auto c) {
    int regs = 0;
    return prepare<decltype(c)>(&regs) == cudaSuccess ? regs : -regs;
  });
}

// bf16 q/k/v/o.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int B, int Lq, int Lk, int H, int D, float scale,
                                       void* stream_ptr) {
  if (!valid_head_dim(D) || Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_config(D, Lq, [&](auto c) {
    return (int)launch<decltype(c)>(q, k, v, o, B, Lq, Lk, H, D, scale, stream);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
