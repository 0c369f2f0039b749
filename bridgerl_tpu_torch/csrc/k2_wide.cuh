// K2's nearest-code search past 512 columns (vq_assign.cu includes this), on
// the tensor cores.
//
// Replaces, with vq_assign.cu's kernels: bridgerl_tpu/ops/pallas/vq_kernel.py,
// nearest_codes_pallas (:106, pallas_call at :118). The JAX package sends D
// past 512 to XLA; the port takes every D on the card.
//
// What bounds it on an H100: operations, 2 N K D, done here as three tf32
// products each (3 x 2 N K D over the 495 TFLOP/s of the tf32 tensor cores):
// 25.7 us at (N 4096, D 1024, K 512), 3.3 us at N 512. x and the codebook
// are read once (5.4 us at 3.35 TB/s for the first). The column-chunk kernel
// this replaces staged x and the codes chunk by chunk, waited for every copy
// before scoring on the float32 cores, and ran at 8-20% of the float32
// cores' bound, slower than its plain version (PERF.md §6). Measured on an
// H100 (PERF.md §6): 0.122 ms at (4096, 1024, 512), 21% of this bound;
// the products take about 70% of a block's cycles and its stage waits 12-18%
// (tools/k2_phases.py), the blocks run in two waves at N 4096, and the
// statistics kernel ends 10-24 us after the last of them.
//
// Design.
// 1. vq_code_norms: one thread a code adds its squares in column order in
//    float32 (the rows staged through shared memory by 32-code blocks),
//    once per code, into the caller's counts buffer, which the
//    statistics kernel overwrites only after the nearest-code kernel has
//    ended. It is launched first; the nearest-code kernel is its programmatic
//    dependent, streams and multiplies while it runs, and waits for it
//    (griddepcontrol.wait) only before its first epilogue.
// 2. vq_assign_wide: a cluster of C = min(8, slices) blocks takes `tiles` row
//    tiles of TR (32 or 64) rows; rank r scores them against code slices r,
//    r + C, ... of 64 codes (vq_assign.cu's split, with its (dist, idx)
//    winners pushed to the row's owner and ties to the lowest index). A block
//    is four consumer warps, 2 x 2 over (rows, codes), each (TR / 2) x 32 of
//    mma.sync m16n8k8 tf32 accumulators held in registers over all of D, and
//    one producer warp. D streams through a ring of kStages stages of 32
//    columns (128 bytes a row, laid out in the 128-byte swizzle, so that the
//    fragment loads of a warp fall in 32 banks): there is no barrier of the
//    whole block between steps, only each stage's full and empty mbarriers.
//    The producer fills stage s while the consumers multiply the stages
//    before it. With TMA (D a multiple of 4, 16-byte aligned rows), one
//    thread issues the stage's code slice for its own block and its share of
//    the x tile, 8-row pieces multicast to every block of the cluster: the x
//    tile is read once per cluster, not once per rank. A stage is refilled
//    when the consumer warps of every block of the cluster have released it
//    (remote arrives on each rank's empty barrier). Other D (not a multiple
//    of 4) or rows off 16 bytes: the producer warp stages the block's own
//    tile with 4-byte cp.async into the same layout, and arrives on the full
//    barrier as its copies land.
//    Products are 3xTF32, as csrc/k1_mma.cuh's float32 path: x = hi + lo +
//    r with hi, lo tf32 by masking the mantissa, |r| < 2^-20 |x|, and lo*hi +
//    hi*lo + hi*hi a product, so each dot product keeps float32's accuracy;
//    plain TF32's 10 bits flip nearest codes. The epilogue of a slice reads
//    its 64 norms, takes dist = |e|^2 - 2 x.e, and keeps a running (dist,
//    idx) per row in registers over the slices, codes in increasing order
//    with a strict <; the quad's and the two code halves' winners are then
//    taken in the lexicographic order of (dist, idx).
// A stage wait that does not end in about 2 s traps: a fault, not a hung card.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from libcuda (dlsym)
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "k1_mma.cuh"

// Phase marks, empty unless tools/k2_phases.py defines K2W_PHASES: per block,
// thread 0 sums the cycles its consumer warp spends waiting for stages (0), in
// the products (1) and in the slices' epilogues (2), the producer's lane 0 its
// waits for free stages (3); the block's start and end (globaltimer) go to 4
// and 5, a norms block's to 6 and 7.
#ifdef K2W_PHASES
__device__ long long g_k2w_phase[8 * 65536];
#define K2W_NS(v) unsigned long long v; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
#define K2W_T(v) const long long v = clock64();
#define K2W_ADD(i, v) k2w_sum[i] += clock64() - (v);
#define K2W_SLOT(i) g_k2w_phase[(i) * 65536 + blockIdx.x + blockIdx.y * gridDim.x]
extern "C" int k2w_phases(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k2w_phase, sizeof(g_k2w_phase));
}
#else
#define K2W_NS(v)
#define K2W_T(v)
#define K2W_ADD(i, v)
#endif

namespace k2w {

namespace cg = cooperative_groups;

constexpr int kCols = 32;         // columns a stage holds: 128 bytes of a row
constexpr int kStages = 4;        // the ring
constexpr int kCodes = 64;        // codes per slice
constexpr int kWarps = 4;         // consumer warps, 2 x 2 over (rows, codes)
constexpr int kThreads = 32 * (kWarps + 1);   // and the producer warp
constexpr int kPiece = 8;         // rows of an x copy: one 1024-byte swizzle atom
constexpr int kMaxCluster = 8;
constexpr int kNormThreads = 256;   // the norms kernel: threads issuing its copies
constexpr int kNormCols = 128;      // its chunks' columns
constexpr int kNormStages = 4;      // and their ring
constexpr int kNormStride = kNormCols + 4;   // a row's floats: 16-byte reads of 8 rows, 8 banks
constexpr int kNormSmem = kNormStages * 32 * kNormStride * 4;
constexpr int kRowBytes = 4 * kCols;
constexpr long long kWaitLimitCycles = 4000000000ll;   // about 2 s

// Shared memory of vq_assign_wide (ops/vq_kernel.py::wide_smem mirrors it):
// alignment slack for the swizzle's 1024-byte atoms, the ring of (x tile,
// code slice) stages, a full and an empty barrier a stage, the two code
// halves' winners per row, and a (best, idx) per row of the cluster's tiles
// from each rank.
__host__ __device__ constexpr int stage_bytes(int TR) { return (TR + kCodes) * kRowBytes; }
inline size_t wide_smem(int TR, int tiles) {
  return 1024 + (size_t)kStages * stage_bytes(TR) + 16 * kStages + 16 * (size_t)TR +
         8 * (size_t)kMaxCluster * tiles * TR;
}

// float offset of (row r, column c) of a stage's part: the 16-byte chunk c / 4
// of row r sits at chunk (c / 4) ^ (r % 8), as TMA's 128-byte swizzle puts it
__device__ __forceinline__ int sw(int r, int c) {
  return r * kCols + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity ph of barrier b to complete. The clock is read
// only after 1024 polls, so that a wait that ends at once costs none.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t ph) {
  const uint32_t a = smem_u32(b);
  long long t0 = 0;
  for (unsigned spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(ph)
        : "memory");
    if (done) return;
    if ((spin & 1023u) == 1023u) {
      const long long t = clock64();
      if (spin == 1023u)
        t0 = t;
      else if (t - t0 > kWaitLimitCycles)
        __trap();
    }
  }
}

// Arrive on barrier b of the cluster's block `cta` (this block's own included),
// with the default release at the block's scope: what it orders are this
// warp's reads of the stage. A release at the cluster's scope fences every
// arrive: it cost 1,100 cycles a stage, half of the block's time.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* b, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(b)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* m, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same copy into every block of the cluster in `mask`, each block's own
// barrier (at bar's offset) told of its bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* m, int c0,
                                                   int c1, int c2, uint64_t* bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// The four groups of 8 columns of one stage: acc[mt][nt] += X rows . E codes
// (3xTF32). xo and eo are the thread's offsets of its first A and B element
// (row xr0 + gq, code cr0 + gq, column tq); its rows are 8-aligned past them,
// so the swizzle's XOR is with gq: chunk 2 kk of the thread's rows sits at
// ((2 kk) ^ gq) * 4 floats, chunk 2 kk + 1 at that ^ 4 (gx = 4 gq).
template <int MT, int NT>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4], const float* X,
                                          const float* E, int xo, int eo, int gx) {
#pragma unroll
  for (int kk = 0; kk < kCols / 8; ++kk) {
    const int o0 = (kk << 3) ^ gx, o1 = o0 ^ 4;
    const float* xa = X + xo;
    const float* eb = E + eo;
    unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* r = xa + mt * 16 * kCols;
      k1::split_tf32(r[o0], ah[mt][0], al[mt][0]);
      k1::split_tf32(r[8 * kCols + o0], ah[mt][1], al[mt][1]);
      k1::split_tf32(r[o1], ah[mt][2], al[mt][2]);
      k1::split_tf32(r[8 * kCols + o1], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* r = eb + nt * 8 * kCols;
      k1::split_tf32(r[o0], bh[nt][0], bl[nt][0]);
      k1::split_tf32(r[o1], bh[nt][1], bl[nt][1]);
    }
    // the small terms first; each pass over the MT x NT tiles before the next,
    // so that consecutive mma.sync do not wait on each other
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) k1::mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) k1::mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) k1::mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
  }
}

// A block takes 32 codes: their rows stream through shared memory in chunks of
// kNormCols columns, a ring of kNormStages (all kNormThreads threads issue the
// coalesced 16-byte cp.async, 4-byte where rows are off 16 bytes; columns past
// D read as 0), and the first warp's thread c adds code c's squares in column
// order. A thread a code reading its own row from device memory waited on one
// load after another: ~20 us at D 1024.
__global__ void __launch_bounds__(kNormThreads)
vq_code_norms(const float* __restrict__ cb, float* __restrict__ norms, int K, int D, bool vec) {
  // the nearest-code kernel may start now: it waits for this grid before reading the norms
  asm volatile("griddepcontrol.launch_dependents;");
  K2W_NS(k2w_start)
  extern __shared__ float4 nbuf4[];
  float* buf = reinterpret_cast<float*>(nbuf4);   // [stage][32 rows][kNormStride]
  const int k0 = blockIdx.x * 32, tid = threadIdx.x;
  const int rows = min(32, K - k0);
  cb += ((size_t)blockIdx.y * K + k0) * D;
  const int chunks = (D + kNormCols - 1) / kNormCols;
  auto stage = [&](int c) {
    if (c < chunks) {
      float* dst = buf + (c % kNormStages) * 32 * kNormStride;
      const int c0 = c * kNormCols;
      if (vec) {
        for (int e = tid; e < 32 * kNormCols / 4; e += kNormThreads) {
          const int r = e / (kNormCols / 4), q = 4 * (e % (kNormCols / 4));
          const bool ok = r < rows && c0 + q < D;
          k1::cp_async16_zfill(dst + r * kNormStride + q, ok ? cb + (size_t)r * D + c0 + q : cb,
                               ok);
        }
      } else {
        for (int e = tid; e < 32 * kNormCols; e += kNormThreads) {
          const int r = e / kNormCols, q = e % kNormCols;
          const bool ok = r < rows && c0 + q < D;
          k1::cp_async4_zfill(dst + r * kNormStride + q, ok ? cb + (size_t)r * D + c0 + q : cb,
                              ok);
        }
      }
    }
    k1::cp_async_commit();   // an empty group past the last chunk keeps the count
  };
  for (int c = 0; c < kNormStages - 1; ++c) stage(c);
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) {
    stage(c + kNormStages - 1);
    k1::cp_async_wait<kNormStages - 1>();
    __syncthreads();
    if (tid < 32) {
      const float4* row =
          reinterpret_cast<const float4*>(buf + ((c % kNormStages) * 32 + tid) * kNormStride);
#pragma unroll 8
      for (int q = 0; q < kNormCols / 4; ++q) {
        const float4 v = row[q];
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
      }
    }
    __syncthreads();   // this stage has been read before it is refilled
  }
  if (tid < rows) norms[(size_t)blockIdx.y * K + k0 + tid] = s;
#ifdef K2W_PHASES
  K2W_NS(k2w_end)
  if (tid == 0) K2W_SLOT(6) = (long long)k2w_start, K2W_SLOT(7) = (long long)k2w_end;
#endif
}

template <int TR, bool TMA>
__global__ void __launch_bounds__(kThreads, 3)
vq_assign_wide(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tc,
               const float* __restrict__ x, const float* __restrict__ cb,
               const float* __restrict__ norms, int* __restrict__ idx, int N, int D, int K,
               int spb, int tiles) {
  // the consumer warps: 2 x 2 over (rows, codes), each MT x NT tiles of 16 x 8
  constexpr int NT = 4, WN = 2, MT = TR / 32;
  constexpr int SB = stage_bytes(TR), XB = TR * kRowBytes;
  K2W_NS(k2w_start)
#ifdef K2W_PHASES
  long long k2w_sum[4] = {0, 0, 0, 0};
#endif
  // the statistics kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * SB);
  uint64_t* empty = full + kStages;
  float* cand_d = reinterpret_cast<float*>(empty + kStages);   // [code half][TR]
  int* cand_i = reinterpret_cast<int*>(cand_d + 2 * TR);
  float* wd = reinterpret_cast<float*>(cand_i + 2 * TR);       // [rank][tile row] pushed winners
  int* wi = reinterpret_cast<int*>(wd + kMaxCluster * tiles * TR);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int grp = blockIdx.y;
  x += (size_t)grp * N * D;
  cb += (size_t)grp * K * D;
  norms += (size_t)grp * K;
  idx += (size_t)grp * N;
  const int tile0 = (blockIdx.x / C) * tiles;         // this cluster's first row tile
  const int ntiles = min(tiles, (N + TR - 1) / TR - tile0);
  const int slices = (K + kCodes - 1) / kCodes;
  const int steps = (D + kCols - 1) / kCols;
  const int total = ntiles * spb * steps;              // the same in every block of the cluster
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], TMA ? kWarps * C : kWarps);   // TMA: the cluster's consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();   // every block's barriers are set before any copy or remote arrive

  if (warp == kWarps) {   // the producer
    for (int it = 0; it < total; ++it) {
      const int s = it % kStages;
      const int st = it % steps, rest = it / steps, j = rest % spb, t = rest / spb;
      const int k0 = (rank + j * C) * kCodes, row0 = (tile0 + t) * TR;
      unsigned char* stage = ring + s * SB;
      if constexpr (TMA) {
        if (lane == 0) {
          K2W_T(k2w_a)
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);   // a fresh barrier passes at once
          K2W_ADD(3, k2w_a)
          mbar_expect_tx(&full[s], SB);
          tma_load(smem_u32(stage + XB), &tc, st * kCols, k0, grp, &full[s]);
          for (int p = rank; p < TR / kPiece; p += C)
            tma_load_multicast(smem_u32(stage + p * kPiece * kRowBytes), &tx, st * kCols,
                               row0 + p * kPiece, grp, &full[s], (uint16_t)((1u << C) - 1));
        }
      } else {
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        float* xs = reinterpret_cast<float*>(stage);
        float* cs = reinterpret_cast<float*>(stage + XB);
        const int c = st * kCols + lane;
        const bool col = c < D;
        for (int r = 0; r < TR; ++r) {
          const bool ok = col && row0 + r < N;
          k1::cp_async4_zfill(xs + sw(r, lane), ok ? x + (size_t)(row0 + r) * D + c : x, ok);
        }
        for (int r = 0; r < kCodes; ++r) {
          const bool ok = col && k0 + r < K;
          k1::cp_async4_zfill(cs + sw(r, lane), ok ? cb + (size_t)(k0 + r) * D + c : cb, ok);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                         smem_u32(&full[s]))
                     : "memory");
      }
    }
  } else {   // the consumers
    const int wm = warp / WN, wn = warp % WN, gq = lane >> 2, tq = lane & 3;
    const int xr0 = wm * (TR / 2), cr0 = wn * 8 * NT;
    const int xo = (xr0 + gq) * kCols + tq, eo = (cr0 + gq) * kCols + tq, gx = gq << 2;
    bool norms_ready = false;
    int it = 0;
    for (int t = 0; t < ntiles; ++t) {
      float best[MT][2];
      int bidx[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          best[mt][h] = INFINITY;
          bidx[mt][h] = K;   // no code yet: loses every comparison
        }
      for (int j = 0; j < spb; ++j) {
        const int slice = rank + j * C;
        const bool live = slice < slices;   // the same for the whole block
        float acc[MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
        for (int st = 0; st < steps; ++st, ++it) {
          const int s = it % kStages;
          K2W_T(k2w_a)
          mbar_wait(&full[s], (it / kStages) & 1);
          K2W_ADD(0, k2w_a)
          const float* X = reinterpret_cast<const float*>(ring + s * SB);
          K2W_T(k2w_b)
          if (live) mma_stage<MT, NT>(acc, X, X + TR * kCols, xo, eo, gx);
          K2W_ADD(1, k2w_b)
          __syncwarp();
          if (TMA ? lane < C : lane == 0)   // the stage is read here
            mbar_arrive_remote(&empty[s], TMA ? lane : rank);
        }
        if (!live) continue;
        K2W_T(k2w_c)
        if (!norms_ready) {   // vq_code_norms has ended and its norms are visible
          asm volatile("griddepcontrol.wait;" ::: "memory");
          norms_ready = true;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {   // increasing code index
            const int k = slice * kCodes + cr0 + nt * 8 + 2 * tq + e;
            const float norm = k < K ? __ldcg(norms + k) : INFINITY;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float dist = norm - 2.f * acc[mt][nt][2 * h + e];
                if (dist < best[mt][h]) {
                  best[mt][h] = dist;
                  bidx[mt][h] = k;
                }
              }
          }
        K2W_ADD(2, k2w_c)
      }
      // the quad's winner per row, then the WN code parts' through shared memory
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float d = __shfl_xor_sync(0xffffffffu, best[mt][h], off);
            const int i = __shfl_xor_sync(0xffffffffu, bidx[mt][h], off);
            if (before(d, i, best[mt][h], bidx[mt][h])) {
              best[mt][h] = d;
              bidx[mt][h] = i;
            }
          }
          if (tq == 0) {
            const int r = xr0 + mt * 16 + gq + 8 * h;
            cand_d[wn * TR + r] = best[mt][h];
            cand_i[wn * TR + r] = bidx[mt][h];
          }
        }
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kWarps) : "memory");
      const int rows = min(TR, N - (tile0 + t) * TR);
      if (threadIdx.x < rows) {
        const int lr = threadIdx.x;
        float b = cand_d[lr];
        int k = cand_i[lr];
#pragma unroll
        for (int q = 1; q < WN; ++q)
          if (before(cand_d[q * TR + lr], cand_i[q * TR + lr], b, k)) {
            b = cand_d[q * TR + lr];
            k = cand_i[q * TR + lr];
          }
        const int e = t * TR + lr;   // the row's place among the cluster's rows
        const int owner = e % C, slot = rank * tiles * TR + e;
        cluster.map_shared_rank(wd, owner)[slot] = b;
        cluster.map_shared_rank(wi, owner)[slot] = k;
      }
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kWarps) : "memory");   // read before refilled
    }
  }
  __syncwarp();
  cluster.sync();   // every push has landed; no block reads another's memory after this

  // the cluster's winner for the rows this rank owns: e = rank + C m
  for (int e = rank + C * threadIdx.x; e < ntiles * TR; e += C * kThreads) {
    const int row = tile0 * TR + e;
    if (row >= N) break;
    float b = INFINITY;
    int k = K;
    for (int q = 0; q < C; ++q) {
      const int slot = q * tiles * TR + e;
      if (before(wd[slot], wi[slot], b, k)) {
        b = wd[slot];
        k = wi[slot];
      }
    }
    idx[row] = k < K ? k : 0;   // every distance inf: code 0, as argmin gives
  }
#ifdef K2W_PHASES
  K2W_NS(k2w_end)
  if (threadIdx.x == 0)
    K2W_SLOT(0) = k2w_sum[0], K2W_SLOT(1) = k2w_sum[1], K2W_SLOT(2) = k2w_sum[2],
    K2W_SLOT(4) = (long long)k2w_start, K2W_SLOT(5) = (long long)k2w_end;
  if (threadIdx.x == 32 * kWarps) K2W_SLOT(3) = k2w_sum[3];
#endif
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder (the runtime has loaded libcuda), or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A (G, rows, D) float32 tensor read in boxes of (box_rows, 32 columns), each
// landing in the 128-byte swizzle; rows and columns past the tensor read 0.
inline bool tensor_map(CUtensorMap* m, const float* p, int G, int rows, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)G};
  const cuuint64_t strides[2] = {4ull * D, 4ull * D * rows};
  const cuuint32_t box[3] = {(cuuint32_t)kCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int TR, bool TMA>
cudaError_t launch_wide_tr(const cudaLaunchConfig_t& cfg, const CUtensorMap& tx,
                           const CUtensorMap& tc, const float* x, const float* cb,
                           const float* norms, int* idx, int N, int D, int K, int spb,
                           int tiles) {
  const cudaError_t e = k1::allow_smem(vq_assign_wide<TR, TMA>, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, vq_assign_wide<TR, TMA>, tx, tc, x, cb, norms, idx, N, D, K,
                            spb, tiles);
}

// The norms into `norms` (the caller's counts), then the nearest codes as their
// programmatic dependent, in clusters of `cluster` blocks.
inline cudaError_t launch_wide(const float* x, const float* cb, float* norms, int* idx,
                               int groups, int N, int D, int K, int TR, int cluster, int spb,
                               int tiles, int smem, cudaStream_t stream) {
  const bool tma = D % 4 == 0 && ((uintptr_t)x | (uintptr_t)cb) % 16 == 0;
  CUtensorMap tx, tc;
  memset(&tx, 0, sizeof(tx));
  memset(&tc, 0, sizeof(tc));
  if (tma && !(tensor_map(&tx, x, groups, N, D, kPiece) &&
               tensor_map(&tc, cb, groups, K, D, kCodes)))
    return cudaErrorNotSupported;
  cudaError_t e = k1::allow_smem(vq_code_norms, kNormSmem);
  if (e != cudaSuccess) return e;
  vq_code_norms<<<dim3((K + 31) / 32, groups), kNormThreads, kNormSmem, stream>>>(cb, norms, K,
                                                                                  D, tma);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int row_tiles = (N + TR - 1) / TR;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((row_tiles + tiles - 1) / tiles), groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if (TR == 64)
    return tma ? launch_wide_tr<64, true>(cfg, tx, tc, x, cb, norms, idx, N, D, K, spb, tiles)
               : launch_wide_tr<64, false>(cfg, tx, tc, x, cb, norms, idx, N, D, K, spb, tiles);
  return tma ? launch_wide_tr<32, true>(cfg, tx, tc, x, cb, norms, idx, N, D, K, spb, tiles)
             : launch_wide_tr<32, false>(cfg, tx, tc, x, cb, norms, idx, N, D, K, spb, tiles);
}

}  // namespace k2w
