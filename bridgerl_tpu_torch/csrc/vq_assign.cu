// K2: nearest-code search with assignment statistics.
//   idx[n]    = first argmin_k ( ||e_k||^2 - 2 x_n . e_k )      (int32)
//   counts[k] = number of rows n with idx[n] == k                (float32)
//   dw[k, :]  = sum of the rows x_n with idx[n] == k, added in increasing n
//
// Replaces: bridgerl_tpu/ops/pallas/vq_kernel.py, nearest_codes_pallas
// (:106, pallas_call at :118, kernel body _vq_assign_kernel at :51). The TPU
// kernel carries counts and dw from one step of its sequential grid to the
// next, so it adds the rows in a fixed order. Hopper's blocks run in no
// order, so here a second kernel owns the codes and adds each code's rows in
// increasing n: no atomics on the outputs and no zeroed outputs, and dw
// equals the plain version's row-order index_add_ on the CPU bit for bit,
// on every run.
//
// Shapes: x (N, D), codebook (K, D), float32, contiguous; any N >= 1, any
// K >= 1, 1 <= D <= 512. Groups: x (G, N, D) and codebook (G, K, D) give
// idx (G, N), counts (G, K) and dw (G, K, D), each group searched against
// its own codebook and summed on its own, bit for bit what G launches of
// one group give (the seeds of a stacked multi-seed step, which jax.vmap
// gives one instance each of the TPU kernel). Both kernels take the group
// from a grid dimension of their own (y for the nearest codes, whose
// clusters run along x; z for the statistics), so one launch covers them
// all; G = 1 is the single launch. The launch plan (tile rows, cluster size, slices
// per block, tiles per cluster, shared-memory bytes, rows per statistics
// pass) comes from the caller (ops/vq_kernel.py::k2_plan) and is checked
// here.
//
// What bounds it on an H100: operations, 2 N K D over the 67 TFLOP/s of the
// float32 cores. At training's (N 512, D 64, K 512) that is 33.5 MFLOP,
// 0.5 us, less than the cost of a launch itself; at serving's N = 4096 it
// is 4.0 us. The bytes (x and the codebook read once, idx, counts and dw
// written once) take 0.1-0.4 us at 3.35 TB/s. So the design spreads the
// scoring over every SM and keeps each block's serial chain short; what is
// left at N = 512 is mostly the cost of two launches (PERF.md).
//
// Design.
// 1. vq_assign_nearest: the codes are split into slices of 64, and the C =
//    min(8, slices) blocks of a thread-block cluster take one slice each
//    (rank r takes slices r, r + C, ... when K > 512) for the same row
//    tiles. At the training shape that is 16 tiles of 32 rows x 8 ranks =
//    128 blocks on 132 SMs, where a block per 32 rows walking the whole
//    codebook would be 16. With one slice per rank a cluster takes several
//    row tiles (2 of 64 rows at N = 4096): the slice and its norms are
//    staged once, and the next x tile streams in with cp.async while the
//    current one is scored. A block of 128 threads stages tiles with
//    16-byte cp.async into rows padded to D' + 4 floats (D' = D rounded up
//    to 8) and computes the slice's 64 norms with every thread. Thread
//    (g, c) of 8 x 16 scores rows g, g + 8, ... (TR / 8 of them) against
//    codes c, c + 16, c + 32, c + 48 from float4 reads: per 4 columns, 4
//    code loads and TR / 8 row loads (one address per half warp) feed
//    16 TR / 8 FMAs. The eight threads of a quarter warp read eight
//    different code rows, which the odd stride puts in eight bank groups.
//    Each thread keeps a running (best, idx) per row over its codes in
//    increasing order with a strict <; the threads' candidates go to
//    shared memory, one thread per row takes their lexicographic minimum of
//    (dist, idx) and pushes it into the shared memory of the rank that owns
//    the row through distributed shared memory; after one cluster barrier
//    each owner takes the minimum over the ranks and writes idx. Ties
//    therefore go to the lowest index, however the codes are split. D = 64,
//    the flagship, is a template argument, so the score loop unrolls; other
//    D run the same kernel with a runtime D. The tensor cores are not used:
//    TF32 flips nearest codes, and at N = 4096 the float32 scoring already
//    runs near the float32 cores' rate (PERF.md).
// 2. vq_assign_stats: a block of 8 warps owns 8 codes, a warp one code and
//    64 columns (two per lane). The block reads idx once (16-byte loads) and
//    sets one bit per row of its codes in a bitmap per code in shared
//    memory; each warp then walks its bitmap in row order and lists its
//    code's rows (a prefix sum over the lanes' bit counts), then loads their
//    values 32 rows at a time, the next 32 in flight while one window is
//    added, and adds them in list order. It writes counts[k] and dw[k, :]
//    once. A popular code's adds are one serial chain; its loads, not the
//    adds, set the kernel's time (PERF.md).
//    It is launched as a programmatic dependent of the first kernel: its
//    blocks may start and clear their bitmaps while the first kernel runs,
//    and wait for its end (griddepcontrol.wait) before reading idx.
// The (N, K) distance and one-hot matrices never exist in device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "k1_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCodes = 64;        // codes per slice
constexpr int kCodeGroups = 16;   // threads across a slice: 4 codes each
constexpr int kRowGroups = 8;     // threads down a tile: TR / 8 rows each
constexpr int kThreads = kCodeGroups * kRowGroups;
constexpr int kCand = kCodeGroups + 1;  // candidate row stride: 32 rows hit 32 banks
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kStatWarps = 8;     // codes per statistics block, one warp each
constexpr int kStatCols = 64;     // columns per statistics warp, two per lane
constexpr int kWindow = 32;       // rows a statistics lane loads at a time
constexpr int kListRows = 2048;   // rows a statistics warp lists before adding them
constexpr int kMaxPassRows = 32768;

// Padded row stride in floats: D rounded up to 8, plus 4. Row r's 16-byte
// column c then falls in bank group (r * S / 4 + c) mod 8 with S / 4 odd.
__host__ __device__ inline int row_stride(int D) { return (D + 7) / 8 * 8 + 4; }

// Floats of one x-tile buffer: the tile, or afterwards the threads'
// candidates (a (dist, idx) per row and code group).
__host__ __device__ inline int xbuf_floats(int tile_rows, int D) {
  const int tile = tile_rows * row_stride(D), cands = 2 * kCand * tile_rows;
  return tile > cands ? tile : cands;
}

// Shared memory of vq_assign_nearest: an x-tile buffer (two when a block
// takes more than one tile), the code slice, its norms, and a (best, idx)
// per row of the cluster's tiles from each rank.
inline size_t nearest_smem(int tile_rows, int D, int tiles) {
  return sizeof(float) * ((tiles > 1 ? 2 : 1) * (size_t)xbuf_floats(tile_rows, D) +
                          (size_t)kCodes * row_stride(D) + kCodes +
                          2 * (size_t)kMaxCluster * tiles * tile_rows);
}

// Shared memory of vq_assign_stats: a bitmap of pass_rows bits and a list
// of kListRows rows per warp.
inline size_t stats_smem(int pass_rows) {
  return sizeof(int) * (size_t)kStatWarps * (pass_rows / 32 + kListRows);
}

// Copy `valid` rows of D floats (contiguous at src) into n rows of stride S
// at dst; the rest of the n rows, and the columns up to the next multiple
// of 4, are zero. vec (D % 4 == 0 and 16-byte aligned sources): cp.async,
// completed by the caller's wait; otherwise plain loads and stores.
template <int DK>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int valid,
                                      int n, int D, int S, bool vec) {
  const int D4 = DK ? DK / 4 : (D + 3) / 4;
  if (vec) {
    for (int e = threadIdx.x; e < n * D4; e += blockDim.x) {
      const int r = e / D4, c = e - r * D4;
      float* d = dst + r * S + 4 * c;
      if (r < valid)
        k1::cp_async16(d, src + 4 * (size_t)e);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const int W = 4 * D4;
    for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
      const int r = e / W, c = e - r * W;
      dst[r * S + c] = (r < valid && c < D) ? __ldg(src + (size_t)r * D + c) : 0.f;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One float4 column of a thread's (RPT rows x 4 codes) tile: rows
// xr + 8 i rows, codes cr + 16 c rows.
template <int RPT>
__device__ __forceinline__ void score_tile(float (&acc)[RPT][4], const float* xr,
                                           const float* cr, int S, int d4) {
  float4 ev[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    ev[c] = *reinterpret_cast<const float4*>(cr + c * kCodeGroups * S + 4 * d4);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + i * kRowGroups * S + 4 * d4);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = k1::dot4(xv, ev[c], acc[i][c]);
  }
}

// Load columns c0 and c1 of rows[0], ..., rows[n - 1] (0 < n <= kWindow)
// of x; the slots past n hold +0.
__device__ __forceinline__ void load_window(const float* __restrict__ x, const int* rows, int n,
                                            unsigned D, int c0, int c1, bool has0, bool has1,
                                            float (&v0)[kWindow], float (&v1)[kWindow]) {
#pragma unroll
  for (int g = 0; g < kWindow; ++g) {
    const float* xr = x + (size_t)(unsigned)rows[min(g, n - 1)] * D;
    v0[g] = has0 && g < n ? xr[c0] : 0.f;
    v1[g] = has1 && g < n ? xr[c1] : 0.f;
  }
}

// Add columns c0 and c1 of rows list[0], ..., list[L - 1] of x to (a0, a1)
// in that order. The next window's loads are in flight while a window is
// added. A slot past the end adds +0, which leaves a sum that started at +0
// unchanged bit for bit (it is never -0).
__device__ __forceinline__ void add_list(const float* __restrict__ x, const int* list, int L,
                                         unsigned D, int c0, int c1, bool has0, bool has1,
                                         float& a0, float& a1) {
  float v0[kWindow], v1[kWindow];
  load_window(x, list, min(L, kWindow), D, c0, c1, has0, has1, v0, v1);
  for (int i0 = 0; i0 < L; i0 += kWindow) {
    float n0[kWindow] = {}, n1[kWindow] = {};
    if (i0 + kWindow < L)  // the same on every lane
      load_window(x, list + i0 + kWindow, min(L - i0 - kWindow, kWindow), D, c0, c1, has0,
                  has1, n0, n1);
#pragma unroll
    for (int g = 0; g < kWindow; ++g) {
      a0 += v0[g];
      a1 += v1[g];
      v0[g] = n0[g];
      v1[g] = n1[g];
    }
  }
}

// (d, i) before (bd, bi) in the lexicographic order of (dist, idx)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <int TR, int DK>
__global__ void __launch_bounds__(kThreads, 2)
vq_assign_nearest(const float* __restrict__ x, const float* __restrict__ cb,
                  int* __restrict__ idx, int N, int D, int K, int spb, int tiles, bool vec) {
  constexpr int RPT = TR / kRowGroups;    // a thread's rows: g, g + 8, g + 16, ...
  constexpr int TPC = kThreads / kCodes;  // threads per code norm
  // the statistics kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  // this block has started; the wait below, before the first write to
  // another block's shared memory, makes sure every block of the cluster has
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  extern __shared__ float4 smem4[];
  x += (size_t)blockIdx.y * N * D;   // this block's group
  cb += (size_t)blockIdx.y * K * D;
  idx += (size_t)blockIdx.y * N;
  const int S = row_stride(DK ? DK : D);
  const int D4 = DK ? DK / 4 : (D + 3) / 4;
  const int XB = xbuf_floats(TR, DK ? DK : D);
  float* xbuf = reinterpret_cast<float*>(smem4);     // x-tile buffers: tile t in t & 1
  float* cs = xbuf + (tiles > 1 ? 2 : 1) * XB;        // the code slice
  float* cn = cs + kCodes * S;                        // its squared norms
  float* wd = cn + kCodes;                            // [rank][tile row] pushed winners
  int* wi = reinterpret_cast<int*>(wd + kMaxCluster * tiles * TR);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int tile0 = (blockIdx.x / C) * tiles;         // this cluster's first row tile
  const int ntiles = min(tiles, (N + TR - 1) / TR - tile0);
  const int slices = (K + kCodes - 1) / kCodes;
  const int rg = threadIdx.x / kCodeGroups, cgi = threadIdx.x % kCodeGroups;
  const bool keep_codes = spb == 1;  // one slice: staged once for every tile

  // the first x tile and, with one slice, the codes: one copy group
  stage<DK>(xbuf, x + (size_t)tile0 * TR * D, min(TR, N - tile0 * TR), TR, D, S, vec);
  if (keep_codes) stage<DK>(cs, cb + (size_t)rank * kCodes * D, min(kCodes, K - rank * kCodes),
                            kCodes, D, S, vec);
  cp_async_commit();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  for (int t = 0; t < ntiles; ++t) {
    const int row0 = (tile0 + t) * TR;
    const int rows = min(TR, N - row0);
    float* xs = xbuf + (t & 1) * XB;
    if (t + 1 < ntiles)  // the next tile streams in while this one is scored
      stage<DK>(xbuf + ((t + 1) & 1) * XB, x + (size_t)(row0 + TR) * D,
                min(TR, N - row0 - TR), TR, D, S, vec);
    cp_async_commit();

    float best[RPT];
    int bidx[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      best[i] = INFINITY;
      bidx[i] = K;  // no code yet: loses every comparison below
    }
    for (int j = 0; j < spb; ++j) {
      const int s = rank + j * C;
      if (s >= slices) break;  // the same for the whole block
      const int k0 = s * kCodes;
      if (!keep_codes) {  // then tiles == 1: nothing else is in flight
        if (j > 0) __syncthreads();  // the previous slice has been read
        stage<DK>(cs, cb + (size_t)k0 * D, min(kCodes, K - k0), kCodes, D, S, vec);
        cp_async_commit();
      }
      if (keep_codes)
        cp_async_wait<1>();  // all but the next tile's copies
      else
        cp_async_wait<0>();
      __syncthreads();
      if (!keep_codes || t == 0) {  // the slice's squared norms; padding codes get inf
        const int c = threadIdx.x / TPC, p = threadIdx.x % TPC;
        const float* e = cs + c * S;
        float sum = 0.f;
        for (int d4 = p; d4 < D4; d4 += TPC) {
          const float4 v = *reinterpret_cast<const float4*>(e + 4 * d4);
          sum = k1::dot4(v, v, sum);
        }
#pragma unroll
        for (int off = TPC / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (p == 0) cn[c] = (k0 + c < K) ? sum : INFINITY;
      }

      float acc[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      const float* xr = xs + rg * S;
      const float* cr = cs + cgi * S;
      if constexpr (DK > 0) {
#pragma unroll
        for (int d4 = 0; d4 < DK / 4; ++d4) score_tile<RPT>(acc, xr, cr, S, d4);
      } else {
#pragma unroll 2
        for (int d4 = 0; d4 < D4; ++d4) score_tile<RPT>(acc, xr, cr, S, d4);
      }
      __syncthreads();  // the norms are in, and the tile has been read
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // increasing code index
        const int lc = cgi + c * kCodeGroups;
        const float norm = cn[lc];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float dist = norm - 2.f * acc[i][c];
          if (dist < best[i]) {
            best[i] = dist;
            bidx[i] = k0 + lc;
          }
        }
      }
    }

    // the block's winner per row: the threads' candidates go over the tile
    // just read; one thread per row takes their minimum and pushes it to
    // the rank that owns the row (its place among the cluster's rows mod C)
    float* cand_d = xs;
    int* cand_i = reinterpret_cast<int*>(xs + kCand * TR);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = rg + i * kRowGroups;
      cand_d[lr * kCand + cgi] = best[i];
      cand_i[lr * kCand + cgi] = bidx[i];
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      const int lr = threadIdx.x;
      float b = INFINITY;
      int k = K;
#pragma unroll
      for (int q = 0; q < kCodeGroups; ++q) {
        const float d = cand_d[lr * kCand + q];
        const int i = cand_i[lr * kCand + q];
        if (before(d, i, b, k)) {
          b = d;
          k = i;
        }
      }
      const int e = t * TR + lr;  // the row's place among the cluster's rows
      const int owner = e % C, slot = rank * tiles * TR + e;
      cluster.map_shared_rank(wd, owner)[slot] = b;
      cluster.map_shared_rank(wi, owner)[slot] = k;
    }
    __syncthreads();  // the candidates have been read before the buffer is refilled
  }
  cluster.sync();  // every push has landed; no block reads another's memory after this

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
    idx[row] = k < K ? k : 0;  // every distance inf: code 0, as argmin gives
  }
}

__global__ void __launch_bounds__(kStatWarps * 32)
vq_assign_stats(const float* __restrict__ x, const int* __restrict__ idx,
                float* __restrict__ counts, float* __restrict__ dw, int N, int D, int K,
                int pass_rows) {
  extern __shared__ unsigned sbits[];  // [warp][pass_rows / 32] bits, then [warp][kListRows] rows
  x += (size_t)blockIdx.z * N * D;   // this block's group
  idx += (size_t)blockIdx.z * N;
  counts += (size_t)blockIdx.z * K;
  dw += (size_t)blockIdx.z * K * D;
  const bool idx16 = ((uintptr_t)idx & 15) == 0;  // a group's rows may start off 16 bytes
  const int words = pass_rows / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kStatWarps, k = k0 + warp;
  const int c0 = blockIdx.y * kStatCols + lane, c1 = c0 + 32;
  const bool has0 = c0 < D, has1 = c1 < D;
  const unsigned* bits = sbits + warp * words;
  int* list = reinterpret_cast<int*>(sbits + kStatWarps * words) + warp * kListRows;
  float a0 = 0.f, a1 = 0.f;
  int n_k = 0, listed = 0;  // rows of code k so far, and those listed but not yet added

  for (int base = 0; base < N; base += pass_rows) {
    const int len = min(pass_rows, N - base);
    __syncthreads();  // the previous pass has walked its bitmaps
    for (int i = threadIdx.x; i < kStatWarps * words; i += blockDim.x) sbits[i] = 0u;
    // idx comes from the nearest-code kernel: wait for its end (a no-op
    // after the first pass)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    __syncthreads();
#pragma unroll 4
    for (int r = 4 * threadIdx.x; r < len; r += 4 * blockDim.x) {
      int v[4];
      if (idx16 && r + 4 <= len) {  // base and r are multiples of 4: 16-byte aligned
        const int4 q = *reinterpret_cast<const int4*>(idx + base + r);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = r + t < len ? idx[base + r + t] : -1;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned w = (unsigned)(v[t] - k0);
        if (w < (unsigned)kStatWarps)
          atomicOr(&sbits[w * words + (r + t) / 32], 1u << ((r + t) % 32));
      }
    }
    __syncthreads();
    if (k >= K) continue;

    for (int w0 = 0; w0 * 32 < len; w0 += 32) {  // 32 words: up to 1024 rows
      unsigned word = w0 + lane < words ? bits[w0 + lane] : 0u;
      const int cnt = __popc(word);
      int incl = cnt;  // inclusive prefix sum of the lanes' counts
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      const int L = __shfl_sync(0xffffffffu, incl, 31);
      if (L == 0) continue;
      if (listed + L > kListRows) {  // no room: add what is listed first
        add_list(x, list, listed, D, c0, c1, has0, has1, a0, a1);
        listed = 0;
        __syncwarp();
      }
      int pos = listed + incl - cnt;
      const int rbase = base + (w0 + lane) * 32;
      while (word) {  // this lane's rows, in increasing order, after those listed
        list[pos++] = rbase + __ffs(word) - 1;
        word &= word - 1;
      }
      __syncwarp();
      n_k += L;
      listed += L;
    }
  }
  if (listed > 0) add_list(x, list, listed, D, c0, c1, has0, has1, a0, a1);
  if (k < K) {
    if (has0) dw[(size_t)k * D + c0] = a0;
    if (has1) dw[(size_t)k * D + c1] = a1;
    if (blockIdx.y == 0 && lane == 0) counts[k] = (float)n_k;
  }
}

template <int TR, int DK>
cudaError_t launch_nearest(const cudaLaunchConfig_t& cfg, const float* x, const float* cb,
                           int* idx, int N, int D, int K, int spb, int tiles, bool vec) {
  const cudaError_t e = k1::allow_smem(vq_assign_nearest<TR, DK>, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, vq_assign_nearest<TR, DK>, x, cb, idx, N, D, K, spb, tiles,
                            vec);
}

}  // namespace

// The plan's numbers are checked against what the kernels need; a plan that
// does not cover every (row, code) pair, or that does not fit, is refused.
extern "C" int vq_assign(const float* x, const float* cb, int* idx, float* counts,
                         float* dw, int groups, int N, int D, int K, int tile_rows,
                         int cluster, int slices_per_block, int tiles_per_cluster,
                         int smem_bytes, int pass_rows, void* stream) {
  if (groups < 1 || groups > 65535 || N < 1 || K < 1 || D < 1 || D > 512)
    return (int)cudaErrorInvalidValue;
  const int slices = (K + kCodes - 1) / kCodes;
  if ((tile_rows != 32 && tile_rows != 64) || cluster < 1 || cluster > kMaxCluster ||
      cluster > slices || (long long)cluster * slices_per_block < slices ||
      tiles_per_cluster < 1 || (slices_per_block > 1 && tiles_per_cluster > 1) ||
      smem_bytes < (long long)nearest_smem(tile_rows, D, tiles_per_cluster) ||
      smem_bytes > k1::kSmemLimit || pass_rows < 32 || pass_rows % 32 != 0 ||
      pass_rows > kMaxPassRows || (long long)stats_smem(pass_rows) > k1::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && ((uintptr_t)x | (uintptr_t)cb) % 16 == 0;
  if ((uintptr_t)idx % 16 != 0) return (int)cudaErrorInvalidValue;

  const int row_tiles = (N + tile_rows - 1) / tile_rows;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((row_tiles + tiles_per_cluster - 1) / tiles_per_cluster),
                     groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int spb = slices_per_block, T = tiles_per_cluster;
  cudaError_t e;
  if (tile_rows == 64)
    e = (D == 64 && vec) ? launch_nearest<64, 64>(cfg, x, cb, idx, N, D, K, spb, T, vec)
                         : launch_nearest<64, 0>(cfg, x, cb, idx, N, D, K, spb, T, vec);
  else
    e = (D == 64 && vec) ? launch_nearest<32, 64>(cfg, x, cb, idx, N, D, K, spb, T, vec)
                         : launch_nearest<32, 0>(cfg, x, cb, idx, N, D, K, spb, T, vec);
  if (e != cudaSuccess) return (int)e;

  const size_t smem = stats_smem(pass_rows);
  e = k1::allow_smem(vq_assign_stats, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute dep[1];
  dep[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t scfg = {};
  scfg.gridDim = dim3((K + kStatWarps - 1) / kStatWarps, (D + kStatCols - 1) / kStatCols,
                      groups);
  scfg.blockDim = dim3(kStatWarps * 32);
  scfg.dynamicSmemBytes = smem;
  scfg.stream = (cudaStream_t)stream;
  scfg.attrs = dep;
  scfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&scfg, vq_assign_stats, x, (const int*)idx, counts, dw, N, D, K,
                         pass_rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
