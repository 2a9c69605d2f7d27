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
// Bytes at or past L read as 0; the plain version pads the same way.  Every
// output of every read is written.
//
// What bounds it on the card.  A main-path call (B = 8192, L = 160, a
// 33-base adapter) reads 1.3 MB: 0.4 us at 3.35 TB/s; the byte compares it
// needs take 0.2 us on the integer pipes at 1.98 GHz.  The kernel before
// this design (commit 1877111) took 0.0289-0.0301 ms a launch (NVIDIA H100
// 80GB HBM3, 700 W): one wave of warps, each as long as its slowest lane's
// serial chain of byte loads from device memory (a compare loop with an
// early exit per start position, and for a read without a Hamming match two
// fallbacks of ~66 dependent steps a lane), several hundred dependent loads
// a warp.
//
// What this design does about it (0.0135-0.0140 ms a launch at that shape
// on the same card, 2.1-2.2 times faster than that kernel in turns; the
// launch floor 0.0015-0.0017 ms; chip_smoke.py --kernel-only --old-kernel
// and kernel_variants.py):
//  * The read is loaded once.  A warp copies its read into shared memory
//    (16-byte loads when L is a multiple of 16, else a byte a lane), 16
//    zero bytes before it and zeros after it, so p < 0 and bytes past L need
//    no branch.  The adapter, zero-padded, is staged once a block (8,192
//    warps reading the same bytes queued on one cache line: 2 us of a
//    launch); each warp's first read is in flight meanwhile, and every
//    next read's length and first vectors while the warp ends the last.
//  * The Hamming scan compares four bytes at once, without branches.  Lane
//    p takes 32-bit words of the staged read at p + i (aligned words and
//    funnel shifts, two words a step) against the adapter's words, a
//    byte-wise "differs" from one add and two logic ops, and __popc, with a
//    mask for the bytes before the read and past cmplen.  Every lane runs
//    the same steps (no lane waits on another's early exit); the warp stops
//    a round once every lane is past its allowance, and __ballot_sync +
//    __ffs pick the first matching position of a round of 32, the
//    reference's first match.
//  * The fallbacks are O(1) a length after one prefix pass.  Both compare
//    from index 0, so with d0[j] = ins[j] != norm[j] (the same for both
//    roles), d1[j] = ins[j + 1] != norm[j], D0 and D1 their prefix sums
//    (D[0] = 0) and E[i] = D0[i] - D1[i], the serial loop for (cl, limit)
//    returns true iff cl >= 2, limit >= 0 and min over 1 <= i < min(f, cl)
//    of E[i] <= limit - D1[cl], where f is the first i >= 1 with
//    D0[i] > limit - d1[cl - 1] (its fail test: D0 never falls, so it fails
//    from f on).  One warp-wide pass over j < top, for both roles at once,
//    takes D0 and D1 from ballots, the position of each mismatch of d0 by
//    its rank (so f is one lookup) and the running minimum of E by warp
//    scans, into shared memory; then a lane per cmplen decides in a few
//    operations, top down in rounds of 32, so the first round with a match
//    gives the largest.  The fail test still comes before the success test
//    (it bounds the minimum's range), and the insertion is still tried
//    first.
//  * Where a warp's staging does not fit the 48 KB of shared memory (an
//    adapter or a read of many kilobytes), the same code runs on a scratch
//    buffer in device memory that the wrapper allocates: no length is
//    refused.
// What still holds it above the bound (kernel_variants.py, copies that end
// at a PHASE mark, in turns, same card: 0.0029-0.0030 ms staged only,
// 0.0108-0.0109 ms without the fallbacks, 0.0135 ms whole): the Hamming
// scan is about 7.9 us of the launch (most reads scan every position,
// about three words each before the warp stops), the fallbacks about 2.6
// us, the staging about 1.4 us over the launch floor.  It issues
// instructions, it does not wait for bytes; 4 or 2 warps a block, or
// fewer blocks with reads a warp in turn, were no faster.
#include <cuda_runtime.h>
#include <stdint.h>

// PHASE(k) marks point k of a block's way through the kernel (0 its start,
// then the end of each phase): kernel_variants.py builds copies that write
// a %globaltimer stamp there, or that end the kernel there; in the port's
// build it is nothing.
#ifndef PHASE
#define PHASE(k)
#endif

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMinFallbackLength = 8;  // cmplen / 8 - 1 >= 0
constexpr int kPad = 16;               // zero bytes before the staged read
constexpr int kFar = 1 << 30;

__device__ __forceinline__ int floor_div8(int x) {
  return x >= 0 ? x / 8 : -((7 - x) / 8);
}

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Bytes [lo, hi) of a word (0 <= lo, hi <= 4) as a byte mask.
__device__ __forceinline__ unsigned byte_mask(int lo, int hi) {
  const unsigned below_hi = static_cast<unsigned>((1ull << (8 * hi)) - 1);
  const unsigned below_lo = static_cast<unsigned>((1ull << (8 * lo)) - 1);
  return hi > lo ? below_hi & ~below_lo : 0u;
}

// The tables of both roles over j < top, in one pass: per role D1
// (top + 1 values) and the running minimum M[m] = min over 1 <= i < m of
// D0[i] - D1[i] (M[1] = kFar); `kth`, the index of each mismatch of d0 by its
// rank (d0 and D0 are the same for both roles); returns their count.  In the
// insertion role ins is the read and norm the adapter, in the deletion role
// the other way round; the deletion's tables stop at top_del.
__device__ int prefix_tables(const uint8_t* row, const uint8_t* ad, int top,
                             int top_del, int lane, int* kth, int* d1_ins,
                             int* min_ins, int* d1_del, int* min_del) {
  int carry0 = 0, carry_ins = 0, carry_del = 0;
  int run_ins = kFar, run_del = kFar;
  if (lane == 0) {
    d1_ins[0] = d1_del[0] = 0;
    min_ins[1] = min_del[1] = kFar;
  }
  const unsigned below = (1u << lane) - 1;
  for (int j0 = 0; j0 < top; j0 += 32) {
    const int j = j0 + lane;
    bool d0 = false, d_ins = false, d_del = false;
    if (j < top) {
      const int r0 = row[kPad + j], r1 = row[kPad + j + 1];
      const int a0 = ad[j], a1 = ad[j + 1];
      d0 = r0 != a0;
      d_ins = r1 != a0;
      d_del = j < top_del && a1 != r0;
    }
    const unsigned m0 = __ballot_sync(kFullMask, d0);
    const unsigned m_ins = __ballot_sync(kFullMask, d_ins);
    const unsigned m_del = __ballot_sync(kFullMask, d_del);
    // D0[j + 1] and D1[j + 1]: the mismatches over [0, j]
    const int D0 = carry0 + __popc(m0 & below) + d0;
    const int D_ins = carry_ins + __popc(m_ins & below) + d_ins;
    const int D_del = carry_del + __popc(m_del & below) + d_del;
    if (d0) kth[D0 - 1] = j;
    // E at i = j + 1 and its running minimum from i = 1 (a lane below the
    // shuffle's distance gets its own value back)
    int e_ins = j < top ? D0 - D_ins : kFar;
    int e_del = j < top_del ? D0 - D_del : kFar;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      e_ins = min(e_ins, __shfl_up_sync(kFullMask, e_ins, s));
      e_del = min(e_del, __shfl_up_sync(kFullMask, e_del, s));
    }
    e_ins = min(e_ins, run_ins);
    e_del = min(e_del, run_del);
    if (j < top) {
      d1_ins[j + 1] = D_ins;
      min_ins[j + 2] = e_ins;  // min over 1 <= i <= j + 1
    }
    if (j < top_del) {
      d1_del[j + 1] = D_del;
      min_del[j + 2] = e_del;
    }
    carry0 += __popc(m0);
    carry_ins += __popc(m_ins);
    carry_del += __popc(m_del);
    run_ins = __shfl_sync(kFullMask, e_ins, 31);
    run_del = __shfl_sync(kFullMask, e_del, 31);
  }
  return carry0;
}

// Matcher::matchWithOneInsertion for cmplen cl from the tables: the serial
// loop's answer in O(1).
__device__ __forceinline__ bool one_insertion(int cl, int limit, int ones,
                                              const int* d1s, const int* mins,
                                              const int* kth) {
  if (cl < 2 || limit < 0) return false;
  const int D1cl = d1s[cl];
  const int t = limit - (D1cl - d1s[cl - 1]);  // limit - d1[cl - 1]
  const int f = t < 0 ? 1 : t < ones ? kth[t] + 1 : kFar;
  const int m = min(f, cl);
  return m >= 2 && mins[m] <= limit - D1cl;
}

// A fallback for the whole warp: the largest matching cmplen in [8, top] and
// the position it gives; returns whether that position is valid.
template <bool kInsertion>
__device__ bool fallback(int top, int rlen, int match_req, int lane, int ones,
                         const int* d1s, const int* mins, const int* kth,
                         int* pos) {
  int best = -1;
  for (int hi = top; hi >= kMinFallbackLength; hi -= 32) {
    const int cl = hi - lane;
    const bool m = cl >= kMinFallbackLength &&
                   one_insertion(cl, cl / 8 - 1, ones, d1s, mins, kth);
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

// A block's workspace (block_bytes): the adapter (ad_bytes, zero-padded),
// then per warp the staged read (row_bytes) and five tables of `table` ints:
// kth, then D1 and the minimum of each role.
template <bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32)
adapter_match_kernel(const uint8_t* __restrict__ bases,
                     const int32_t* __restrict__ lengths,
                     const uint8_t* __restrict__ adapter, int B, int L,
                     int alen, int match_req, int start, bool vector_loads,
                     int ad_bytes, int row_bytes, int table, int block_bytes,
                     uint8_t* __restrict__ scratch,
                     int32_t* __restrict__ new_len, bool* __restrict__ found_out,
                     int32_t* __restrict__ pos_out) {
  extern __shared__ __align__(16) uint8_t s_work[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t* ad = kShared ? s_work : scratch + static_cast<size_t>(blockIdx.x) * block_bytes;
  uint8_t* row = ad + ad_bytes + static_cast<size_t>(warp) * (row_bytes + 20 * table);
  int* kth = reinterpret_cast<int*>(row + row_bytes);
  int* d1_ins = kth + table;
  int* min_ins = d1_ins + table;
  int* d1_del = min_ins + table;
  int* min_del = d1_del + table;
  const unsigned* ad_words = reinterpret_cast<const unsigned*>(ad);
  const unsigned* row_words = reinterpret_cast<const unsigned*>(row);
  const int words = (alen + 3) / 4;
  const int stride = gridDim.x * warps;
  const bool first_vector = vector_loads && lane < L / 16;

  // the first read's length and first 32 vectors are in flight while the
  // block stages the adapter (once a block: every warp of the card reading
  // the same bytes from device memory would queue on one cache line)
  int r = blockIdx.x * warps + warp;
  int rlen = 0;
  int4 v0;
  if (r < B) {
    rlen = lengths[r];
    if (first_vector) v0 = __ldg(reinterpret_cast<const int4*>(bases + static_cast<size_t>(r) * L) + lane);
  }
  for (int i = threadIdx.x; i < ad_bytes; i += blockDim.x) ad[i] = i < alen ? __ldg(adapter + i) : 0;
  __syncthreads();

  for (; r < B; r += stride) {
    PHASE(0);
    // the read, once: zeros before it and from L on
    const uint8_t* src = bases + static_cast<size_t>(r) * L;
    if (first_vector) reinterpret_cast<int4*>(row + kPad)[lane] = v0;
    if (vector_loads) {
      for (int k = lane + 32; k < L / 16; k += 32)
        reinterpret_cast<int4*>(row + kPad)[k] =
            __ldg(reinterpret_cast<const int4*>(src) + k);
    } else {
      for (int j = lane; j < L; j += 32) row[kPad + j] = src[j];
    }
    for (int i = lane; i < kPad / 4; i += 32) reinterpret_cast<unsigned*>(row)[i] = 0u;
    // from the first whole word past the read; a byte-loaded read's last
    // partial word is zeroed byte by byte
    for (int i = (kPad + L + 3) / 4 + lane; i < row_bytes / 4; i += 32)
      reinterpret_cast<unsigned*>(row)[i] = 0u;
    if (lane < ((4 - (kPad + L) % 4) & 3)) row[kPad + L + lane] = 0;
    __syncwarp();

    PHASE(1);  // staged
    bool found = false;
    int pos = 0;
    const int p_end = min(L, rlen) - match_req;  // candidates p < p_end
    for (int base = start; base < p_end; base += 32) {
      const int p = base + lane;
      const int cmplen = min(rlen - p, alen);
      // a lane past the candidates allows nothing: it never matches
      const int allowed = p < p_end ? floor_div8(cmplen) : -1;
      // the high bit of each byte compared: from max(0, -p) in the first
      // word, below cmplen in the last
      const unsigned head = byte_mask(min(max(0, -p), 4), 4) & 0x80808080u;
      const int last = (max(cmplen, 1) - 1) >> 2;
      const unsigned tail = byte_mask(0, min(max(cmplen - 4 * last, 0), 4)) & 0x80808080u;
      int mm = 0;
      // the read's words at p + 4 w: aligned words and funnel shifts, two
      // words a step, the last aligned word kept for the next step
      const int first_word = (kPad + p) >> 2;
      const unsigned shift = 8 * ((kPad + p) & 3);
      unsigned lo = row_words[first_word];
      for (int w = 0; w < words; w += 2) {
        const unsigned mid = row_words[first_word + w + 1];
        const unsigned hi = row_words[first_word + w + 2];
        const unsigned x0 = __funnelshift_r(lo, mid, shift) ^ ad_words[w];
        const unsigned x1 = __funnelshift_r(mid, hi, shift) ^ ad_words[w + 1];
        lo = hi;
        // the high bit of every byte that differs, in the bytes compared
        unsigned m0 = w < last ? 0x80808080u : w == last ? tail : 0u;
        const unsigned m1 = w + 1 < last ? 0x80808080u : w + 1 == last ? tail : 0u;
        if (w == 0) m0 &= head;
        mm += __popc((((x0 & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x0) & m0) +
              __popc((((x1 & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x1) & m1);
        // the warp stops once every lane is past its allowance
        if (__all_sync(kFullMask, mm > allowed)) break;
      }
      const unsigned votes = __ballot_sync(kFullMask, mm <= allowed);
      if (votes) {
        found = true;
        pos = base + __ffs(votes) - 1;
        break;
      }
    }
    if (!found) {
      // d0 is the same for both roles: its ranks over the longer range
      // serve both (a fallback reads them only below its own top)
      const int top_ins = min(rlen - 1, alen);
      const int top_del = min(rlen, alen - 1);
      const int top = max(top_ins, top_del);
      PHASE(2);  // the Hamming scan, found nothing
      if (top >= kMinFallbackLength) {
        const int ones = prefix_tables(row, ad, top, top_del, lane, kth,
                                       d1_ins, min_ins, d1_del, min_del);
        __syncwarp();
        PHASE(3);  // prefix tables
        found = fallback<true>(top_ins, rlen, match_req, lane, ones, d1_ins,
                               min_ins, kth, &pos) ||
                fallback<false>(top_del, rlen, match_req, lane, ones, d1_del,
                                min_del, kth, &pos);
      }
    }
    if (lane == 0) {
      found_out[r] = found;
      pos_out[r] = found ? pos : 0;
      new_len[r] = !found ? rlen : pos < 0 ? 0 : min(pos, rlen);
    }
    __syncwarp();  // the row buffer is rewritten by the next read
    PHASE(4);  // fallback tests, outputs
    // the next read's length and first vectors
    if (r + stride < B) {
      rlen = lengths[r + stride];
      if (first_vector)
        v0 = __ldg(reinterpret_cast<const int4*>(src + static_cast<size_t>(stride) * L) + lane);
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns the launch's CUDA
// error.  The wrapper (ops/adapter_cuda.py:geometry) gives the geometry:
// `warps` warps a block (a read each, in turn), `blocks` blocks, and each
// block's workspace of `block_bytes` (the adapter, then each warp's read and
// tables): dynamic shared memory when `staged`, else `scratch` + block *
// block_bytes in device memory.
extern "C" int adapter_match(const void* bases, const void* lengths,
                             const void* adapter, int B, int L, int alen,
                             int match_req, int warps, int blocks, int staged,
                             int ad_bytes, int row_bytes, int table,
                             int block_bytes, void* scratch, void* new_len,
                             void* found, void* pos, void* stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || blocks < 1 || ad_bytes < alen + 8 ||
      ad_bytes % 16 || row_bytes % 16 || row_bytes < round16(kPad + L + alen + 56) ||
      table < alen + 2 || table % 4 || block_bytes % 16 ||
      block_bytes != ad_bytes + warps * (row_bytes + 20 * table) ||
      (!staged && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int start = alen >= 16 ? -4 : alen >= 12 ? -3 : alen >= 8 ? -2 : 0;
  const bool vector_loads = L % 16 == 0 && reinterpret_cast<uintptr_t>(bases) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // as much of each SM's memory as shared memory as it holds: the default
  // split can hold fewer blocks than the registers allow
  static const cudaError_t carveout = cudaFuncSetAttribute(
      adapter_match_kernel<true>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  if (staged) {
    adapter_match_kernel<true><<<blocks, warps * 32, block_bytes, s>>>(
        static_cast<const uint8_t*>(bases), static_cast<const int32_t*>(lengths),
        static_cast<const uint8_t*>(adapter), B, L, alen, match_req, start,
        vector_loads, ad_bytes, row_bytes, table, block_bytes, nullptr,
        static_cast<int32_t*>(new_len), static_cast<bool*>(found),
        static_cast<int32_t*>(pos));
  } else {
    adapter_match_kernel<false><<<blocks, warps * 32, 0, s>>>(
        static_cast<const uint8_t*>(bases), static_cast<const int32_t*>(lengths),
        static_cast<const uint8_t*>(adapter), B, L, alen, match_req, start,
        vector_loads, ad_bytes, row_bytes, table, block_bytes,
        static_cast<uint8_t*>(scratch), static_cast<int32_t*>(new_len),
        static_cast<bool*>(found), static_cast<int32_t*>(pos));
  }
  return static_cast<int>(cudaGetLastError());
}
