// PE overlap sweep with first-accept selection, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel fastp_tpu/ops/overlap_pallas.py:_mm_kernel (the
// [n_off, B] mismatch matrices mm and mm50, launched twice per batch) together
// with its consumer fastp_tpu/ops/overlap.py:_select_first_accept.  Here no
// [B, n_off] matrix reaches device memory: each pair row finds the first
// accepted offset in the reference's order (all forward offsets, then all
// backward ones), which gives the same answer as the full sweep because the
// first accept wins.
//
// For pair row r, forward offset t (t < len1 - overlap_require):
//   olen = min(len1 - t, len2), compare seq1[t + i] with rc2[i] for i < olen;
// then backward offsets k = 0, 1, ... (k < len2 - overlap_require):
//   olen = min(len1, len2 - k), compare rc2[k + i] with seq1[i], offset = -k.
// An offset is accepted when mm50 <= limit and (mm <= limit or olen > 50),
// with limit = min(diff_limit, (int)(float(olen) * diff_pct)) in float32,
// mm the mismatches over i < olen and mm50 those over i < min(olen, 50).
//
// What bounds it on the card.  A batch (B = 8192, L = 160) is 2.6 MB of
// input and 0.1 MB of output, under a microsecond of memory traffic, so the
// kernel is bound by operations: up to 2 x 130 offsets per row, each a byte
// compare over the overlap.  The integer pipes compare four bytes per 32-bit
// operation, which puts the whole sweep at a few microseconds; what a kernel
// loses beyond that is instruction overhead per byte, serial dependence
// between offsets, and idle lanes.
//
// What the design does about it:
//  * The accept test needs only the first 50 positions.  For olen <= 50 the
//    two counts are the same number, and for olen > 50 the test is
//    mm50 <= limit alone, so "accepted" is mm50 <= limit for every olen.
//    The sweep therefore counts min(olen, 50) positions per offset (13 words
//    at most, not 40), and the full count mm, which only the `diff` output
//    needs, is taken once per row, at the winning offset.
//  * A lane takes an offset, not a position.  One warp owns one pair row; its
//    32 lanes test 32 consecutive offsets at once, each lane keeping its own
//    count in a register, so there is no warp reduction per offset.  One
//    __ballot_sync of the accept flags and __ffs give the lowest accepted
//    offset of the round, which is the reference's first accept.  Forward
//    rounds come first (5 at most at L = 160), and a row runs the backward
//    rounds only when no forward offset was accepted: 10 rounds at most in
//    place of 260 serial steps with two reductions each.
//  * Four bytes per instruction.  Both strings of a row are staged in shared
//    memory (16-byte loads where the row allows it), in rows padded so that
//    a word read may run past the string's end.  A lane reads the fixed
//    string word by word (every lane the same address: a broadcast) and the
//    shifted string at byte offset t + 4w as two aligned words joined by
//    __funnelshift_r, the upper word of one step being the lower word of the
//    next, so each step costs one new load per string.  Neighbouring lanes
//    read neighbouring bytes, so a round touches eight consecutive words and
//    no bank twice.  Differing bytes of a word are counted with a carry trick
//    and __popc; the last word is masked to the overlap's end.  Bytes past a
//    row's length may hold anything and never reach a count.
//  * A round ends as soon as it is decided.  limit <= diff_limit, so a lane
//    whose count has passed diff_limit is rejected whatever follows; after
//    each word one __any_sync asks whether any lane is still undecided, and
//    the warp leaves the round's loop together when none is.  Unrelated
//    strings differ in most positions, so a round without an overlap ends
//    after three or four words instead of thirteen.
//  * The winner's full count is split over the warp's lanes by word and
//    summed with one __reduce_add_sync per row.
// Measured on an H100 (chip_smoke.py, B = 8192, L = 160, bench-like rows):
// 0.012 ms of device time per launch, against 0.162 ms for the earlier
// kernel (one warp per row walking the offsets one by one, a byte per
// instruction, two warp reductions per offset) in the same run, and
// 0.0175 ms before rounds ended early.  What is left is instruction issue
// (some hundreds of warp instructions per row) and the launch itself; the
// wrapper's call takes longer on the host than the kernel on the card.
// Persistent blocks, TMA and clusters were not tried: the input is a few
// megabytes and one wave of blocks (B / 8 = 1024 blocks of 8 warps on 132
// SMs) covers the batch.
//
// The gapped variant (C function overlap_gap_sweep, the kernel's kGap
// instantiation) also replaces the allow_gap branch of
// fastp_tpu/ops/overlap.py:_analyze_loop (:255-318): a row that no ungapped
// offset accepts goes on, with its strings still staged, to the gapped
// offsets, forward ones (0 .. len1 - overlap_require - 1) before backward
// ones (0 .. len2 - overlap_require - 1, k = 0 tested again), and takes the
// first where the one-insertion difference (Matcher::diffWithOneInsertion,
// `gap_diff`) passes the limit; it is then marked has_gap.  At an offset
// with overlap olen, cmplen = olen - 1 and limit from olen, gap_diff(ins,
// norm) is -1 when cmplen < 2 or when accLeft[cmplen - 2] + accRight[cmplen
// - 1] > limit, else the least accLeft[i - 1] + accRight[i] over 1 <= i <
// cmplen, with accLeft the prefix count of ins[i] != norm[i] and accRight
// the suffix count of ins[i + 1] != norm[i] below cmplen.  That least value
// is at most its term at i = cmplen - 1, the very sum the -1 test bounds,
// so a gap_diff that is not -1 passes the limit; and accLeft is the same
// count in both roles (d1 with the seq1 side as ins, d2 with the rc2 side).
// So an offset is accepted when cmplen >= 2 and
//   accLeft[cmplen - 2] + min(x[s + cmplen] != y[cmplen - 1],
//                             y[cmplen] != x[s + cmplen - 1]) <= limit
// (x the shifted string, y the other): the mismatch count over the first
// olen - 2 positions and two byte compares.
//
// Which gapped offsets can still accept, and where they are tested.  A row
// reaches the gapped pass only when every ungapped offset, in both
// directions, was rejected, and this argument holds only for such a row.
// The gapped walk tests the same strings at the same offsets as the
// ungapped one (x, y, s and olen alike), with the same limit.  For olen >
// 50 an ungapped reject means mm50 > limit, mm50 being the mismatches over
// the first 50 positions.  The gapped test rejects whenever
// accLeft[cmplen - 2], the count over the first olen - 2 positions, is over
// the limit; for olen >= 52 that count covers the 50 positions of mm50, so
// it is at least mm50 and the offset is rejected unread.  olen = min(lx -
// s, ly) never grows with s, so the offsets that can still accept are a
// suffix of each direction's walk, from gap_start: s0 = 0 when ly <= 51,
// else max(0, lx - 51).  Nor do they need rounds of their own: at olen <=
// 51 the ungapped test's count covers the first min(olen, 50) >= olen - 2
// positions, so an ungapped round that reaches s0 and rejects all its
// lanes has, in each lane's count, accLeft[cmplen - 2] plus the mismatches
// it counted at positions olen - 2 and olen - 1.  Such a round takes the
// gapped test of its lanes there (gap_accepts: four byte reads, the count
// less those mismatches, the two last compares; count_prefix reports how
// far the warp's loop went, since a lane the loop left early has a count
// that is only a lower bound, and then over the limit) and keeps each
// direction's first gapped accept; the kernel takes it once both
// directions' ungapped rounds have rejected, forward before backward, so
// the first accept stays the reference's.  At lx = ly = 151 and
// overlap_require 30 that is the last ungapped round of each direction,
// where a walk of the gapped offsets from 0 took four more rounds a
// direction.
//
// The one-insertion difference itself (d1, or d2 where d1 is -1 or over
// the limit) is taken once per row, at the winning offset, by the whole
// warp: each lane a run of positions, the prefix of accLeft -
// prefix(accRight) across the lanes by shuffles, the least value and the
// sums by warp reductions (gap_diff_warp).  The roles follow the
// reference, not the sweep's x and y: going forward ins is the shifted
// seq1, going back it is the unshifted seq1 and the shift sits on rc2.
#include <cuda_runtime.h>
#include <stdint.h>

// PHASE(k) marks point k of a warp's way through the kernel (0 its start,
// then the end of each phase it passes): kernel_variants.py builds copies
// that write a %globaltimer stamp there, or that end the kernel there; in
// the port's build it is nothing, so neither instantiation changes.
#ifndef PHASE
#define PHASE(k)
#endif

namespace {

constexpr int kCompleteCompareRequire = 50;
constexpr unsigned kFullMask = 0xffffffffu;

// Bytes of a padded shared-memory row: L rounded up to 16, plus 16, so that
// the word after the last byte of a string (and the one after it) exists.
__host__ __device__ __forceinline__ int row_stride(int L) {
  return ((L + 15) & ~15) + 16;
}

__device__ __forceinline__ int limit_of(int olen, int diff_limit, float diff_pct) {
  const int oc = olen > 0 ? olen : 0;
  const int lim = static_cast<int>(__fmul_rn(static_cast<float>(oc), diff_pct));
  return lim < diff_limit ? lim : diff_limit;
}

// Number of non-zero bytes of x.
__device__ __forceinline__ int nonzero_bytes(unsigned x) {
  const unsigned carry = (x & 0x7f7f7f7fu) + 0x7f7f7f7fu;  // bit 7: low bits set
  return __popc((carry | x) & 0x80808080u);
}

// Mask of the first n bytes of a little-endian word, 0 <= n <= 3.
__device__ __forceinline__ unsigned first_bytes(int n) {
  return (1u << (8 * n)) - 1u;
}

constexpr int kPrefixWords = (kCompleteCompareRequire + 3) / 4;

// Mismatches x[t + i] != y[i] over i < n for each lane's own t and n
// (0 <= n <= 50; a lane with n == 0 reads nothing): x32 and y32 are the
// staged strings as words.  Called by the whole warp, which leaves the loop
// together once no lane can still be accepted: a lane whose count has passed
// diff_limit cannot be (limit <= diff_limit), and its count is then only a
// lower bound, which the accept test still rejects.
__device__ __forceinline__ int count_prefix(const uint32_t* x32, const uint32_t* y32,
                                            int t, int n, int diff_limit) {
  const int q = t >> 2;
  const unsigned sh = 8u * (t & 3);
  int mm = 0;
  uint32_t lo = n > 0 ? x32[q] : 0u;
#pragma unroll
  for (int w = 0; w < kPrefixWords; ++w) {
    const int left = n - 4 * w;  // positions still to count, this word's included
    if (left > 0) {
      const uint32_t hi = x32[q + w + 1];
      uint32_t d = __funnelshift_r(lo, hi, sh) ^ y32[w];
      if (left < 4) d &= first_bytes(left);
      mm += nonzero_bytes(d);
      lo = hi;
    }
    if (!__any_sync(kFullMask, left > 4 && mm <= diff_limit)) break;
  }
  return mm;
}

// First accepted shift s of x against y among 0 <= s < lx - overlap_require,
// 32 shifts a round: returns true and sets *shift and *olen (warp-uniform).
__device__ __forceinline__ bool first_accept(const uint32_t* x32, const uint32_t* y32,
                                             int lx, int ly, int overlap_require,
                                             int diff_limit, float diff_pct, int lane,
                                             int* shift, int* olen_out) {
  const int n_cand = lx - overlap_require;
  for (int base = 0; base < n_cand; base += 32) {
    const int s = base + lane;
    const int olen = min(lx - s, ly);
    const bool cand = s < n_cand;
    const int n = cand ? min(max(olen, 0), kCompleteCompareRequire) : 0;
    const int mm50 = count_prefix(x32, y32, s, n, diff_limit);
    const bool accept = cand && mm50 <= limit_of(olen, diff_limit, diff_pct);
    const unsigned votes = __ballot_sync(kFullMask, accept);
    if (votes) {
      const int win = base + __ffs(votes) - 1;
      *shift = win;
      *olen_out = min(lx - win, ly);
      return true;
    }
  }
  return false;
}

// The gapped variant's own copies of count_prefix and first_accept follow:
// the ungapped kernel keeps the two above as they are, so that its code
// does not change with the gapped one's.

// count_prefix, and in *counted the positions the warp's loop covered,
// 4 (w + 1) for the last word w it took: each lane's count is exact over
// its first min(n, *counted) positions.
__device__ __forceinline__ int count_prefix_counted(const uint32_t* x32,
                                                    const uint32_t* y32, int t,
                                                    int n, int diff_limit,
                                                    int* counted) {
  const int q = t >> 2;
  const unsigned sh = 8u * (t & 3);
  int mm = 0;
  uint32_t lo = n > 0 ? x32[q] : 0u;
  *counted = 4 * kPrefixWords;
#pragma unroll
  for (int w = 0; w < kPrefixWords; ++w) {
    const int left = n - 4 * w;
    if (left > 0) {
      const uint32_t hi = x32[q + w + 1];
      uint32_t d = __funnelshift_r(lo, hi, sh) ^ y32[w];
      if (left < 4) d &= first_bytes(left);
      mm += nonzero_bytes(d);
      lo = hi;
    }
    if (!__any_sync(kFullMask, left > 4 && mm <= diff_limit)) {
      *counted = 4 * (w + 1);
      break;
    }
  }
  return mm;
}

// The first shift of x against y whose gapped test can still pass once
// every ungapped offset of the row has been rejected: the overlap
// min(lx - s, ly) is at most kCompleteCompareRequire + 1 from there on, and
// never grows with s (see the header).
__device__ __forceinline__ int gap_start(int lx, int ly) {
  return ly <= kCompleteCompareRequire + 1
             ? 0 : max(0, lx - kCompleteCompareRequire - 1);
}

// The gapped test of shift s of x against y (olen = min(lx - s, ly),
// cmplen = olen - 1; see the header) for a lane that the ungapped test of
// its round has just rejected, from that test's count mm, exact over the
// first `end` positions.  accLeft[cmplen - 2] is mm less the mismatches at
// positions olen - 2 and olen - 1 where mm counted them.  Where end < olen
// - 2, mm is a lower bound of accLeft[cmplen - 2] and, the lane being
// rejected, over the limit: so is the value taken here, and the test
// rejects as it should.
__device__ __forceinline__ bool gap_accepts(const uint32_t* x32, const uint32_t* y32,
                                            int s, int olen, int end, int mm,
                                            int limit) {
  if (olen < 3) return false;
  const uint8_t* x8 = reinterpret_cast<const uint8_t*>(x32) + s;
  const uint8_t* y8 = reinterpret_cast<const uint8_t*>(y32);
  const int a = x8[olen - 2], b = x8[olen - 1], c = y8[olen - 2], d = y8[olen - 1];
  const int left = mm - (olen - 2 < end && a != c) - (olen - 1 < end && b != d);
  // the lesser of the two roles' last compares (accRight[cmplen - 1])
  return left + ((b != c) & (d != a)) <= limit;
}

// first_accept, and besides: each round that reaches gap_start and finds no
// ungapped accept takes its shifts' gapped tests (gap_accepts) from the
// counts it has just made, until one passes; *gap_shift (-1 before) is then
// the first shift that passed, the gapped walk's answer for this direction
// should the row's ungapped offsets all be rejected.
__device__ __forceinline__ bool first_accept_gap(const uint32_t* x32, const uint32_t* y32,
                                                 int lx, int ly, int overlap_require,
                                                 int diff_limit, float diff_pct, int lane,
                                                 int* shift, int* olen_out,
                                                 int* gap_shift) {
  const int n_cand = lx - overlap_require;
  for (int base = 0; base < n_cand; base += 32) {
    const int s = base + lane;
    const int olen = min(lx - s, ly);
    const bool cand = s < n_cand;
    const int n = cand ? min(max(olen, 0), kCompleteCompareRequire) : 0;
    int counted;
    const int mm50 = count_prefix_counted(x32, y32, s, n, diff_limit, &counted);
    const int limit = limit_of(olen, diff_limit, diff_pct);
    const unsigned votes = __ballot_sync(kFullMask, cand && mm50 <= limit);
    if (votes) {
      const int win = base + __ffs(votes) - 1;
      *shift = win;
      *olen_out = min(lx - win, ly);
      return true;
    }
    if (*gap_shift < 0 && base + 31 >= gap_start(lx, ly)) {
      const unsigned gap_votes = __ballot_sync(
          kFullMask,
          cand && gap_accepts(x32, y32, s, olen, min(n, counted), mm50, limit));
      if (gap_votes) *gap_shift = base + __ffs(gap_votes) - 1;
    }
  }
  return false;
}

// Matcher::diffWithOneInsertion of ins against norm over cmplen positions
// (ins read at i and i + 1, norm at i), by the whole warp; -1 where no
// insertion point passes (cmplen < 2, or accLeft[cmplen - 2] +
// accRight[cmplen - 1] > limit).  With e[j] = (ins[j] != norm[j]) -
// (ins[j + 1] != norm[j]) and R the count of the second term below cmplen,
// accLeft[i - 1] + accRight[i] = R + (e[0] + ... + e[i - 1]): each lane walks
// its own run of positions, a shuffle scan gives each run its start, and
// warp reductions the least prefix, R and accLeft[cmplen - 2].
__device__ __forceinline__ int gap_diff_warp(const uint8_t* ins, const uint8_t* norm,
                                             int cmplen, int limit, int lane) {
  if (cmplen < 2) return -1;  // warp-uniform
  const int per = (cmplen + 31) >> 5;
  const int lo = min(lane * per, cmplen);
  const int hi = min(lo + per, cmplen);
  int run = 0, low = 1 << 30, right = 0, left = 0;
  for (int j = lo; j < hi; ++j) {
    if (j >= 1) low = min(low, run);
    const int ml = ins[j] != norm[j];
    const int mr = ins[j + 1] != norm[j];
    run += ml - mr;
    right += mr;
    if (j < cmplen - 1) left += ml;
  }
  int incl = run;  // inclusive scan of the runs' sums over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += v;
  }
  const int least = __reduce_min_sync(kFullMask, incl - run + low);
  const int accr = __reduce_add_sync(kFullMask, right);
  const int accl = __reduce_add_sync(kFullMask, left);
  if (accl + (ins[cmplen] != norm[cmplen - 1]) > limit) return -1;
  return accr + least;
}

// The diff of a gapped accept: gap_diff with the seq1 side as ins (d1), or,
// where that is -1 or over the limit, with the rc2 side as ins (d2).
__device__ __forceinline__ int gap_diff_of(const uint8_t* seq1_side,
                                           const uint8_t* rc2_side, int olen,
                                           int diff_limit, float diff_pct, int lane) {
  const int limit = limit_of(olen, diff_limit, diff_pct);
  const int d1 = gap_diff_warp(seq1_side, rc2_side, olen - 1, limit, lane);
  if (d1 >= 0 && d1 <= limit) return d1;
  return gap_diff_warp(rc2_side, seq1_side, olen - 1, limit, lane);
}

// Mismatches x[t + i] != y[i] over i < olen, the words split over the lanes
// of the warp; every lane gets the sum.
__device__ __forceinline__ int count_total(const uint32_t* x32, const uint32_t* y32,
                                           int t, int olen, int lane) {
  const int q = t >> 2;
  const unsigned sh = 8u * (t & 3);
  const int words = (olen + 3) >> 2;
  unsigned mm = 0;
  for (int w = lane; w < words; w += 32) {
    uint32_t d = __funnelshift_r(x32[q + w], x32[q + w + 1], sh) ^ y32[w];
    const int left = olen - 4 * w;
    if (left < 4) d &= first_bytes(left);
    mm += nonzero_bytes(d);
  }
  return static_cast<int>(__reduce_add_sync(kFullMask, mm));
}

// Copies one L-byte row into its padded shared-memory row and zeroes the pad.
__device__ __forceinline__ void stage_row(uint8_t* dst, const uint8_t* src, int L,
                                          int stride, bool vec, int lane) {
  if (vec) {  // L is a multiple of 16 and src is 16-byte aligned
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
    const int n = L >> 4;
    for (int i = lane; i < (stride >> 4); i += 32)
      d16[i] = i < n ? s16[i] : make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = lane; i < stride; i += 32) dst[i] = i < L ? src[i] : uint8_t{0};
  }
}

template <bool kGap>
__global__ void overlap_sweep_kernel(const uint8_t* __restrict__ seq1,
                                     const uint8_t* __restrict__ rc2,
                                     const int32_t* __restrict__ len1,
                                     const int32_t* __restrict__ len2,
                                     int B, int L, int diff_limit,
                                     int overlap_require, float diff_pct, bool vec,
                                     bool* __restrict__ overlapped,
                                     int32_t* __restrict__ offset,
                                     int32_t* __restrict__ overlap_len,
                                     int32_t* __restrict__ diff,
                                     bool* __restrict__ has_gap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // warp-uniform; no block-wide barrier follows

  PHASE(0);
  const int stride = row_stride(L);
  uint8_t* a = smem + static_cast<size_t>(warp) * 2 * stride;
  uint8_t* b = a + stride;
  stage_row(a, seq1 + static_cast<size_t>(row) * L, L, stride, vec, lane);
  stage_row(b, rc2 + static_cast<size_t>(row) * L, L, stride, vec, lane);
  __syncwarp();
  PHASE(1);  // staged
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* b32 = reinterpret_cast<const uint32_t*>(b);

  // lengths lie in [0, L] for every caller; clamp so a bad one cannot read
  // outside the staged row
  const int l1 = min(max(len1[row], 0), L);
  const int l2 = min(max(len2[row], 0), L);

  int shift = 0, ol = 0, off = 0, df = 0, gap_f = -1, gap_b = -1;
  bool found = kGap ? first_accept_gap(a32, b32, l1, l2, overlap_require,
                                       diff_limit, diff_pct, lane, &shift, &ol,
                                       &gap_f)
                    : first_accept(a32, b32, l1, l2, overlap_require, diff_limit,
                                   diff_pct, lane, &shift, &ol);
  PHASE(2);  // ungapped forward rounds
  if (found) {
    off = shift;
    df = count_total(a32, b32, shift, ol, lane);
  } else {
    found = kGap ? first_accept_gap(b32, a32, l2, l1, overlap_require,
                                    diff_limit, diff_pct, lane, &shift, &ol,
                                    &gap_b)
                 : first_accept(b32, a32, l2, l1, overlap_require, diff_limit,
                                diff_pct, lane, &shift, &ol);
    if (found) {
      off = -shift;
      df = count_total(b32, a32, shift, ol, lane);
    }
  }
  PHASE(3);  // ungapped backward rounds, the winner's full count
  bool gapped = false;
  if (kGap && !found) {
    // the gapped tests ran inside the ungapped rounds: the first gapped
    // accept going forward, else going back, is the gapped walk's
    PHASE(4);
    PHASE(5);
    if (gap_f >= 0) {  // ins of d1: the shifted seq1
      gapped = true;
      off = gap_f;
      ol = min(l1 - gap_f, l2);
      df = gap_diff_of(a + gap_f, b, ol, diff_limit, diff_pct, lane);
    } else if (gap_b >= 0) {  // ins of d1: the unshifted seq1, the shift on rc2
      gapped = true;
      off = -gap_b;
      ol = min(l1, l2 - gap_b);
      df = gap_diff_of(a, b + gap_b, ol, diff_limit, diff_pct, lane);
    }
    found = gapped;
  }
  PHASE(6);  // the gapped winner's one-insertion difference
  if (lane == 0) {
    overlapped[row] = found;
    offset[row] = found ? off : 0;
    overlap_len[row] = found ? ol : 0;
    diff[row] = found ? df : 0;
    if (kGap) has_gap[row] = gapped;
  }
  PHASE(7);  // the store
}

template <bool kGap>
int launch(const void* seq1, const void* rc2, const void* len1, const void* len2,
           int B, int L, int diff_limit, int overlap_require, float diff_pct,
           void* overlapped, void* offset, void* overlap_len, void* diff,
           void* has_gap, int warps_per_block, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + warps_per_block - 1) / warps_per_block;
  const size_t smem = static_cast<size_t>(warps_per_block) * 2 * row_stride(L);
  const bool vec = (L & 15) == 0 &&
                   ((reinterpret_cast<uintptr_t>(seq1) |
                     reinterpret_cast<uintptr_t>(rc2)) & 15) == 0;
  overlap_sweep_kernel<kGap><<<grid, warps_per_block * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq1), static_cast<const uint8_t*>(rc2),
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2), B, L,
      diff_limit, overlap_require, diff_pct, vec, static_cast<bool*>(overlapped),
      static_cast<int32_t*>(offset), static_cast<int32_t*>(overlap_len),
      static_cast<int32_t*>(diff), static_cast<bool*>(has_gap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// A block takes `warps_per_block` rows and 2 * row_stride(L) bytes of shared
// memory for each (the wrapper keeps that under the 48 KB default).
extern "C" int overlap_sweep(const void* seq1, const void* rc2, const void* len1,
                             const void* len2, int B, int L, int diff_limit,
                             int overlap_require, float diff_pct,
                             void* overlapped, void* offset, void* overlap_len,
                             void* diff, int warps_per_block, void* stream) {
  return launch<false>(seq1, rc2, len1, len2, B, L, diff_limit, overlap_require,
                       diff_pct, overlapped, offset, overlap_len, diff, nullptr,
                       warps_per_block, stream);
}

// The gapped variant: the same, then the one-insertion pass over the rows
// left unaccepted; has_gap (bool[B]) marks the rows it accepted.
extern "C" int overlap_gap_sweep(const void* seq1, const void* rc2, const void* len1,
                                 const void* len2, int B, int L, int diff_limit,
                                 int overlap_require, float diff_pct,
                                 void* overlapped, void* offset, void* overlap_len,
                                 void* diff, void* has_gap, int warps_per_block,
                                 void* stream) {
  return launch<true>(seq1, rc2, len1, len2, B, L, diff_limit, overlap_require,
                      diff_pct, overlapped, offset, overlap_len, diff, has_gap,
                      warps_per_block, stream);
}
