// Philox4x32-10 (Salmon, Moraes, Dror, Shaw: "Parallel random numbers: as
// easy as 1, 2, 3", SC'11), the counter-based generator of K1's dropout.
//
// Both K1 kernels call attn_keep_bits(seed, row, i * S + j) for the element
// (i, j) of (batch * head) row `row`: key (seed, 0), counter (i * S + j, row,
// 0, 0), first output word. The backward regenerates the forward's mask
// from the seed alone. The plain version is ops/attention.py::philox4x32;
// counter 0 and key 0 give 6627e8d5 e169c58d bc57ac4c 9b00dbd8 (Random123's
// known-answer vector).
//
// Seed groups: a launch over G groups of group_rows rows each (the seeds of
// a stacked multi-seed step, folded into B * H) reads seed_ptr[g] for the
// rows of group g and numbers them from 0 within the group, so group g's
// mask is bit for bit the mask of a launch of its own over group_rows rows
// with seed g. One group (group_rows = B * H) is the single-seed launch.
#pragma once

__device__ __forceinline__ unsigned attn_keep_bits(unsigned seed, unsigned row,
                                                   unsigned ctr) {
  unsigned c0 = ctr, c1 = row, c2 = 0u, c3 = 0u;
  unsigned k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ unsigned attn_keep_bits_grouped(const int* __restrict__ seed_ptr,
                                                           int group_rows, unsigned r,
                                                           unsigned ctr) {
  const unsigned g = r / (unsigned)group_rows;
  return attn_keep_bits((unsigned)__ldg(seed_ptr + g), r - g * (unsigned)group_rows, ctr);
}
