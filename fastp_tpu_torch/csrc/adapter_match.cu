// Adapter trimming by sequence (trim_by_sequence) for Hopper (sm_90a).
//
// Replaces fastp_tpu/ops/adapter.py:57 trim_by_sequence with its
// _match_with_one_insertion_static tables (:26), which are not a Pallas
// kernel: there an unrolled Hamming scan over the adapter's bases and one
// static table per candidate length, and in the port's plain version
// (fastp_tpu_torch/ops/adapter.py:trim_by_sequence_plain) some two thousand
// small torch ops a call.  One launch here gives, per read of the batch, what
// AdapterTrimmer::trimBySequence (src/adaptertrimmer.cpp:95-170) gives:
//   * the Hamming scan: the first p, from -4, -3 or -2 by adapter length (0
//     below 8), with p < min(rlen, L) - match_req, where the adapter matches
//     read[p ..] with at most cmplen / 8 (floored) mismatches over
//     cmplen = min(rlen - p, alen); a base before the read is no mismatch;
//   * else the insertion fallback, else the deletion fallback: the reference
//     calls Matcher::matchWithOneInsertion (src/matcher.cpp:10-54) on the
//     read from index 0 whatever p is (src/adaptertrimmer.cpp:120-147), so a
//     fallback depends on p only through cmplen.  The largest matching cmplen
//     from 8 (limit cmplen / 8 - 1 >= 0) up to min(rlen - 1, alen) (insertion)
//     or min(rlen, alen - 1) (deletion) gives p: 0 at that top length, else
//     rlen - 1 - cmplen or rlen - cmplen, valid when 0 <= p < rlen - match_req
//     - 1 (insertion) or rlen - match_req (deletion);
//   * found, pos (0 when none) and the new length: 0 for p < 0, min(p, rlen)
//     otherwise, rlen when nothing matched.
// Bytes at or past L read as 0; the plain version pads the same way.
//
// What bounds it on the card.  A main-path call (B = 8192, L = 160, a
// 33-base adapter) reads 1.3 MB: 0.4 us at 3.35 TB/s.  The work is byte
// compares: a candidate position is decided after a few compares when the
// adapter is absent (the allowance is 4 at 33 bases, and 3 of 4 random bases
// differ), all 33 when it matches; reads with no Hamming match (most of them)
// then test the fallback lengths, O(cmplen) each.  So it is bound by
// operations, and what a kernel loses is idle lanes and serial steps.
//
// What the design does about it:
//  * A warp per read, a lane per start position: 32 positions at once, each
//    lane counting its own mismatches in a register and leaving as soon as
//    the count passes the allowance; __ballot_sync and __ffs pick the first
//    matching position of a round, which is the reference's first match, and
//    the warp stops at the first round that has one (as the overlap kernel,
//    csrc/overlap_sweep.cu, picks the first accepted offset).
//  * The fallbacks run only for a read with no Hamming match (the result
//    prefers the Hamming match, so nothing else reads them), a lane per
//    cmplen, top down in rounds of 32, so the first round with a match gives
//    the largest.  A lane's test is one pass for the suffix count and one
//    scan that stops at the reference's first decision (its fail test first).
//  * The adapter is staged in shared memory (every lane reads the same
//    adapter byte at once: a broadcast); one longer than the default 48 KB of
//    dynamic shared memory is read from device memory instead, so no length
//    is refused.  Reads come from device memory through L1: neighbouring
//    lanes read neighbouring bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMinFallbackLength = 8;   // cmplen / 8 - 1 >= 0
constexpr int kMaxStaged = 48 * 1024;   // default dynamic shared memory

__device__ __forceinline__ int floor_div8(int x) {
  return x >= 0 ? x / 8 : -((7 - x) / 8);
}

// Byte j >= 0 of a read: 0 at or past the row's width.
__device__ __forceinline__ int read_at(const uint8_t* row, int L, int j) {
  return j < L ? row[j] : 0;
}

// The Hamming test at position p: at most `allowed` mismatches of
// adapter[i] against read[p + i] over max(0, -p) <= i < cmplen.
__device__ bool hamming_match(const uint8_t* row, int L, const uint8_t* ad,
                              int p, int cmplen, int allowed) {
  if (allowed < 0) return false;
  int mm = 0;
  for (int i = max(0, -p); i < cmplen; ++i) {
    mm += read_at(row, L, p + i) != ad[i];
    if (mm > allowed) return false;
  }
  return true;
}

// Matcher::matchWithOneInsertion(ins, norm, cl, limit) as the plain version
// states it: accLeft[i] = mismatches ins[j] != norm[j] over j <= i,
// accRight[i] = mismatches ins[j + 1] != norm[j] over i <= j < cl; for
// i = 1 .. cl - 1 in order, false once accLeft[i-1] + accRight[cl-1] > limit,
// true once accLeft[i-1] + accRight[i] <= limit.  kInsertion: ins is the read
// and norm the adapter; otherwise the other way round.
template <bool kInsertion>
__device__ bool one_insertion(const uint8_t* row, int L, const uint8_t* ad,
                              int cl, int limit) {
  if (cl < 2 || limit < 0) return false;
  auto ins = [&](int j) { return kInsertion ? read_at(row, L, j) : int(ad[j]); };
  auto norm = [&](int j) { return kInsertion ? int(ad[j]) : read_at(row, L, j); };
  int right_total = 0;
  for (int j = 0; j < cl; ++j) right_total += ins(j + 1) != norm(j);
  const int right_last = ins(cl) != norm(cl - 1);
  int left = 0;          // accLeft[i - 1]
  int right_before = 0;  // mismatches ins[j + 1] != norm[j] over j < i
  for (int i = 1; i < cl; ++i) {
    left += ins(i - 1) != norm(i - 1);
    right_before += ins(i) != norm(i - 1);
    if (left + right_last > limit) return false;
    if (left + (right_total - right_before) <= limit) return true;
  }
  return false;
}

// A fallback for the whole warp: the largest matching cmplen in
// [8, top] and the position it gives; returns whether that position is valid.
template <bool kInsertion>
__device__ bool fallback(const uint8_t* row, int L, const uint8_t* ad, int alen,
                         int rlen, int match_req, int lane, int* pos) {
  const int top = kInsertion ? min(rlen - 1, alen) : min(rlen, alen - 1);
  int best = -1;
  for (int hi = top; hi >= kMinFallbackLength; hi -= 32) {
    const int cl = hi - lane;
    const bool m = cl >= kMinFallbackLength &&
                   one_insertion<kInsertion>(row, L, ad, cl, cl / 8 - 1);
    const unsigned votes = __ballot_sync(kFullMask, m);
    if (votes) {
      best = hi - (__ffs(votes) - 1);
      break;
    }
  }
  if (best < 0) return false;
  const int p = best == top ? 0 : (kInsertion ? rlen - 1 - best : rlen - best);
  const int p_limit = kInsertion ? rlen - match_req - 1 : rlen - match_req;
  if (p < 0 || p >= p_limit || p_limit <= 0) return false;
  *pos = p;
  return true;
}

__global__ void __launch_bounds__(kWarps * 32)
adapter_match_kernel(const uint8_t* __restrict__ bases,
                     const int32_t* __restrict__ lengths,
                     const uint8_t* __restrict__ adapter, int B, int L,
                     int alen, int match_req, int start, int staged,
                     int32_t* __restrict__ new_len, bool* __restrict__ found_out,
                     int32_t* __restrict__ pos_out) {
  extern __shared__ uint8_t s_adapter[];
  for (int i = threadIdx.x; i < staged; i += blockDim.x) s_adapter[i] = adapter[i];
  __syncthreads();
  const uint8_t* ad = staged ? s_adapter : adapter;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= B) return;  // warp-uniform; no block-wide barrier follows
  const uint8_t* row = bases + static_cast<size_t>(r) * L;
  const int rlen = lengths[r];

  bool found = false;
  int pos = 0;
  const int p_end = min(L, rlen) - match_req;  // candidates p < p_end
  for (int base = start; base < p_end; base += 32) {
    const int p = base + lane;
    bool m = false;
    if (p < p_end) {
      const int cmplen = min(rlen - p, alen);
      m = hamming_match(row, L, ad, p, cmplen, floor_div8(cmplen));
    }
    const unsigned votes = __ballot_sync(kFullMask, m);
    if (votes) {
      found = true;
      pos = base + __ffs(votes) - 1;
      break;
    }
  }
  if (!found) found = fallback<true>(row, L, ad, alen, rlen, match_req, lane, &pos);
  if (!found) found = fallback<false>(row, L, ad, alen, rlen, match_req, lane, &pos);
  if (lane == 0) {
    found_out[r] = found;
    pos_out[r] = pos;
    new_len[r] = !found ? rlen : pos < 0 ? 0 : min(pos, rlen);
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// A block takes 8 reads (a warp each) and the adapter in `staged` bytes of
// dynamic shared memory, or none when it is longer than 48 KB.
extern "C" int adapter_match(const void* bases, const void* lengths,
                             const void* adapter, int B, int L, int alen,
                             int match_req, void* new_len, void* found,
                             void* pos, void* stream) {
  if (B <= 0) return 0;
  const int start = alen >= 16 ? -4 : alen >= 12 ? -3 : alen >= 8 ? -2 : 0;
  const int staged = alen <= kMaxStaged ? alen : 0;
  adapter_match_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, staged,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(adapter), B, L, alen, match_req, start, staged,
      static_cast<int32_t*>(new_len), static_cast<bool*>(found),
      static_cast<int32_t*>(pos));
  return static_cast<int>(cudaGetLastError());
}
