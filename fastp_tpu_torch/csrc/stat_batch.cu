// Per-cycle read statistics of one batch (stat_batch) for Hopper (sm_90a).
//
// Replaces fastp_tpu/ops/stats.py:26 stat_batch, which is not a Pallas kernel:
// there it is XLA reductions over the batch axis, an equality reduction for
// the quality histogram and a bf16 one-hot matmul for the 5-mer histogram
// (stats.py:82-92), and in the port's plain version
// (fastp_tpu_torch/ops/stats.py:stat_batch_plain) about a hundred small torch
// ops with three index_add_ scatters.  One launch here computes the same
// int64 accumulators over the reads r with include[r], at the positions
// p < lengths[r] of each (p < L):
//   cycle_content/q20/q30/qual[8][L]  per slot s = base & 7: the count, the
//                                     count with qual >= '5' and >= '?', and
//                                     the sum of qual - 33
//   cycle_total_base/qual[L]          the same over every slot
//   qual_hist[128]                    the raw quality byte, clamped to 127
//   kmer[2048]                        the 10-bit key sum_k v[p-k] << 2k over the
//                                     five bases ending at p (A=0 T=1 C=2 G=3),
//                                     p >= 4, all five ACGT; bins 1024.. stay 0
//   reads, length_sum                 over the included reads
// in one int64 buffer, in that order (the wrapper, ops/stats_cuda.py, cuts it
// into the plain version's dict).  Every value of it is written: the caller
// need not zero it.
//
// What bounds it on the card.  A main-path call (B = 8192, L = 160) reads
// 2.6 MB and writes 45 KB: 0.81 us at 3.35 TB/s.  The integer work (about 8
// operations per base of an included read and 4 per counted 5-mer) is 0.71
// us on the integer pipes at 1.98 GHz: bytes bound it, the operations close
// behind.  The kernel before this design (commit 1877111) took
// 0.0182-0.0192 ms a launch (NVIDIA H100 80GB HBM3, 700 W): its warps walked
// ~20 rows each with one row of loads in flight, four re-reads of L1 per
// 5-mer, and its flush added each block's non-zero sums to the zeroed
// output with up to ~580k 64-bit atomics, ~52 of them on each column-sum
// address, after a separate zeroing node.
//
// What this design does about it (0.0149-0.0155 ms a launch at that shape
// on the same card, 1.22-1.27 times faster than that kernel in turns and
// 1.43-1.45 times at L = 320; the launch floor 0.0014-0.0017 ms;
// chip_smoke.py --kernel-only --old-kernel; the time by phase below is the
// median over blocks of kernel_variants.py's %globaltimer stamps):
//  * Every byte a block needs is in flight at once (1.4 us).  A block owns
//    one tile of 32 cycle columns and a chunk of at most 128 rows: 320
//    blocks at the main path's shape, all resident at once.  It first loads
//    the chunk's lengths and include flags (a thread a row), its bases from
//    16 columns before the tile to its end (the 5-mer halo) and its
//    qualities into shared memory, with 16-byte loads when L is a multiple
//    of 16 (else a byte a thread), every load issued before any is stored.
//  * Column sums in registers (2.4 us).  Lane c takes column c, the warps
//    walk the rows in turn; a register cannot be indexed by the slot
//    (base & 7), so a slot pair's three counts sit in one register as
//    16-bit fields, its raw quality sums in another, and four predicated
//    adds pick the pair; one shared atomic per slot and lane ends it.
//  * Histograms from the staged rows (2.1 us).  A thread takes 16
//    consecutive cycles of one row: their 2-bit codes four bases at a time
//    (SIMD byte compares; 0x80 marks a byte that is not ACGT), the 5-mer key
//    rolling along them from the 4 codes before the segment, one shared
//    atomic per 5-mer and one per run of equal quality bins (binned
//    qualities make long runs).
//  * A flush without contended atomics on one address and without a
//    zeroing node (4.7 us from the first cluster barrier on).  The blocks
//    of a thread block cluster (8 chunks of one tile) sum the cluster's
//    sums in slices through distributed shared memory, every block of the
//    cluster at once (not with remote atomics into the first block, which
//    made that block the cluster's queue);
//    each block adds its slice's non-zero sums to an int64 accumulator (one
//    per device, stream and L, zero between launches) and takes a ticket.
//    The blocks of the cluster that holds the last ticket write every value
//    of the output together (the totals as sums over the slots, bins
//    1024.. as 0, four loads in flight a thread; one block alone took
//    longer, and a thread per column's 32 values cost registers and so
//    occupancy) and set the accumulator and the ticket back to 0: the next
//    launch, and every replay of a CUDA graph that holds this one, starts
//    from zero.  The cluster size is the C function's argument (1 to 8);
//    the wrapper passes 8, the fastest in turns (kernel_variants.py:
//    0.0152 ms a launch, 4 blocks 0.0156-0.0157, 1 block 0.0214-0.0215).
//  * Nothing grows with L: any width is a number of column tiles.
// What still holds it above the bound: each phase waits for the one before
// (staging latency, then the counting, then the cluster barrier, the
// accumulator's atomics, the fence and the ticket, the last cluster's
// output), so the launch is a chain of latencies, not of bandwidth:
// kernel_variants.py's copies that end at a PHASE mark take 0.0026-0.0027
// ms staged only and 0.0090-0.0091 ms without the flush, against
// 0.0151-0.0153 ms whole.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// PHASE(k) marks point k of a block's way through the kernel (0 its start,
// then the end of each phase): kernel_variants.py builds copies that write
// a %globaltimer stamp there, or that end the kernel there; in the port's
// build it is nothing.
#ifndef PHASE
#define PHASE(k)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kHalo = 16;                 // bases staged before the tile
constexpr int kBaseRow = kHalo + kTile;   // staged bases of a row
constexpr int kMaxRows = 128;             // rows of a chunk (10-bit fields)
constexpr int kSlots = 8;
constexpr int kSlotValues = 4 * kSlots;   // content, q20, q30, qual per slot
constexpr int kQualBins = 128;
constexpr int kKmerKeys = 1024;
constexpr int kKmerBins = 2048;
// a block's sums: packed counts and quality sums of each slot and tile
// column, the quality histogram, the 5-mer keys, reads and length_sum
constexpr int kSums = 2 * kSlots * kTile + kQualBins + kKmerKeys + 2;
constexpr int kSegment = 16;              // cycles a thread takes for the histograms
constexpr int kSegments = kTile / kSegment;
static_assert(kMaxRows * kSegments == kThreads, "a thread per row segment");
static_assert(kMaxRows / kWarps <= 31 && kMaxRows / kWarps * 255 <= 0xffff,
              "a thread's counts and quality sums fit 5- and 16-bit fields");
constexpr int kQ20 = '5';
constexpr int kQ30 = '?';
constexpr int kMaxCluster = 8;
constexpr int kStageLoads = (kMaxRows * 5 + kThreads - 1) / kThreads;

// the bases' 2-bit codes, four bytes at once: A=0 T=1 C=2 G=3 from bits 1
// and 2 of the byte, 0x80 for any byte that is not A, C, G or T
__device__ __forceinline__ unsigned base_codes(unsigned x) {
  const unsigned v = (((x >> 1) & 0x01010101u) << 1) | ((x >> 2) & 0x01010101u);
  const unsigned acgt = __vcmpeq4(x, 0x41414141u) | __vcmpeq4(x, 0x43434343u) |
                        __vcmpeq4(x, 0x47474747u) | __vcmpeq4(x, 0x54545454u);
  return v | (~acgt & 0x80808080u);
}

__device__ __forceinline__ void add_int64(long long* dst, int v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            static_cast<unsigned long long>(static_cast<long long>(v)));
}

// Value i of the output buffer from the accumulator: the slot values as they
// are, the totals as sums over the slots, the quality and 5-mer bins, 0 for
// 5-mer bins 1024.., reads and length_sum.
__device__ __forceinline__ long long output_value(const long long* acc, long long i,
                                                  int L) {
  const long long n_slot = static_cast<long long>(kSlotValues) * L;
  if (i < n_slot) return __ldcg(acc + i);
  if (i < n_slot + 2 * L) {
    const long long t = i - n_slot;
    const int ch = t < L ? 0 : 3;  // content or quality
    const long long pc = t < L ? t : t - L;
    long long v = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) v += __ldcg(acc + (ch * kSlots + s) * L + pc);
    return v;
  }
  const long long k = i - n_slot - 2 * L;
  if (k < kQualBins + kKmerKeys) return __ldcg(acc + n_slot + k);
  if (k < kQualBins + kKmerBins) return 0;
  return __ldcg(acc + n_slot + kQualBins + kKmerKeys + (k - kQualBins - kKmerBins));
}

__global__ void __launch_bounds__(kThreads)
stat_batch_kernel(const uint8_t* __restrict__ bases,
                  const uint8_t* __restrict__ quals,
                  const int32_t* __restrict__ lengths,
                  const uint8_t* __restrict__ include, int B, int L,
                  int rows_per_block, int launched, bool vector_loads,
                  long long* __restrict__ acc, long long* __restrict__ out) {
  // the block's sums, one array: packed counts [slot][lane] (count | q20 <<
  // 10 | q30 << 20), quality sums [slot][lane], the quality bins, the 5-mer
  // keys, reads and length_sum
  __shared__ int s_sums[kSums];
  int* s_cnt = s_sums;
  int* s_qs = s_sums + kSlots * kTile;
  int* s_qual = s_sums + 2 * kSlots * kTile;
  int* s_kmer = s_qual + kQualBins;
  int* s_reads = s_kmer + kKmerKeys;
  __shared__ int s_end[kMaxRows];  // min(length, L) of an included row, else 0
  __shared__ bool s_last;
  // the staged chunk: bases from kHalo columns before the tile, qualities
  __shared__ __align__(16) uint8_t s_b[kMaxRows * kBaseRow];
  __shared__ __align__(16) uint8_t s_q[kMaxRows * kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.x * kTile;
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = max(0, min(rows_per_block, B - row0));
  PHASE(0);

  for (int i = tid; i < kSums; i += kThreads) s_sums[i] = 0;
  // every load of the chunk before any counting
  int my_len = 0;
  bool my_inc = false;
  if (tid < rows) {
    my_len = lengths[row0 + tid];
    my_inc = include[row0 + tid] != 0;
  }
  if (vector_loads) {
    // 3 vectors of bases (the halo and the tile) and 2 of qualities a row
    // (L % 16 == 0, so a vector lies wholly inside the row or outside it),
    // at most kStageLoads a thread: all of them issued before any is stored
    int4 got[kStageLoads];
    uint8_t* dst[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int v = tid + u * kThreads;
      dst[u] = nullptr;
      if (v >= rows * 5) continue;
      const int r = v / 5, k = v % 5;
      const size_t row = static_cast<size_t>(row0 + r) * L;
      const int col = k < 3 ? c0 - kHalo + 16 * k : c0 + 16 * (k - 3);
      if (col < 0 || col >= L) continue;
      got[u] = __ldg(reinterpret_cast<const int4*>((k < 3 ? bases : quals) + row + col));
      dst[u] = k < 3 ? s_b + r * kBaseRow + 16 * k : s_q + r * kTile + 16 * (k - 3);
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u)
      if (dst[u]) *reinterpret_cast<int4*>(dst[u]) = got[u];
  } else {
    for (int v = tid; v < rows * (kBaseRow + kTile); v += kThreads) {
      const int r = v / (kBaseRow + kTile), k = v % (kBaseRow + kTile);
      const size_t row = static_cast<size_t>(row0 + r) * L;
      if (k < kBaseRow) {
        const int col = c0 - kHalo + k;
        if (col >= 0 && col < L) s_b[r * kBaseRow + k] = bases[row + col];
      } else {
        const int col = c0 + k - kBaseRow;
        if (col < L) s_q[r * kTile + k - kBaseRow] = quals[row + col];
      }
    }
  }
  if (tid < rows) {
    s_end[tid] = my_inc ? min(my_len, L) : 0;
  }
  __syncthreads();
  PHASE(1);  // staged
  if (blockIdx.x == 0 && warp * 32 < rows) {
    // reads and length_sum, from the first column tile only
    const unsigned n = __reduce_add_sync(0xffffffffu, my_inc ? 1u : 0u);
    const unsigned sum = __reduce_add_sync(0xffffffffu,
                                           my_inc ? static_cast<unsigned>(my_len) : 0u);
    if (lane == 0) {
      atomicAdd(&s_reads[0], static_cast<int>(n));
      atomicAdd(&s_reads[1], static_cast<int>(sum));
    }
  }

  // the (slot, column) sums: lane c takes column c, the warps walk the rows
  // in turn, in registers: a slot pair's counts in one register as 16-bit
  // fields (count | q20 << 5 | q30 << 10, a thread walks at most
  // kMaxRows / kWarps <= 31 rows), its raw quality sums in another, the
  // pair chosen by four predicated adds; then one shared atomic per slot
  // adds them to the block's sums (packed again as 10-bit fields: a block
  // holds at most kMaxRows rows)
  const int p = c0 + lane;
  if (p < L) {
    unsigned cnt[kSlots / 2], qsum[kSlots / 2];
#pragma unroll
    for (int k = 0; k < kSlots / 2; ++k) {
      cnt[k] = 0u;
      qsum[k] = 0u;
    }
    for (int r = warp; r < rows; r += kWarps) {
      if (p >= s_end[r]) continue;
      const unsigned b = s_b[r * kBaseRow + kHalo + lane];
      const unsigned q = s_q[r * kTile + lane];
      const unsigned shift = (b & 1u) * 16;  // the slot's half of its pair
      const unsigned add = (1u | (static_cast<unsigned>(q >= kQ20) << 5) |
                            (static_cast<unsigned>(q >= kQ30) << 10)) << shift;
      const unsigned qs = q << shift;
      const unsigned pair = (b >> 1) & 3u;
#pragma unroll
      for (int k = 0; k < kSlots / 2; ++k) {
        if (pair == k) {
          cnt[k] += add;
          qsum[k] += qs;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const unsigned f = (cnt[s / 2] >> (16 * (s % 2))) & 0xffffu;
      if (f) {
        const int n = f & 31u;
        atomicAdd(&s_cnt[s * kTile + lane],
                  n | (((f >> 5) & 31u) << 10) | (((f >> 10) & 31u) << 20));
        atomicAdd(&s_qs[s * kTile + lane],
                  static_cast<int>((qsum[s / 2] >> (16 * (s % 2))) & 0xffffu) - 33 * n);
      }
    }
  }
  PHASE(2);  // column sums

  // the histograms: a thread takes kSegment consecutive cycles of one row,
  // the 5-mer key rolling along them from 2-bit codes made four bases at a
  // time; a run of equal quality bins is added with one shared atomic
  // (binned qualities make long runs), each 5-mer with its own
  {
    const int r = tid / kSegments, seg = tid % kSegments;
    const int p0 = c0 + seg * kSegment;
    const int end = r < rows ? min(s_end[r], p0 + kSegment) : p0;
    if (p0 < end) {
      const unsigned* bw = reinterpret_cast<const unsigned*>(s_b + r * kBaseRow +
                                                             kHalo + seg * kSegment - 4);
      const unsigned* qw = reinterpret_cast<const unsigned*>(s_q + r * kTile +
                                                             seg * kSegment);
      unsigned codes[kSegment / 4 + 1], qs[kSegment / 4];
#pragma unroll
      for (int w = 0; w <= kSegment / 4; ++w) codes[w] = base_codes(bw[w]);
#pragma unroll
      for (int w = 0; w < kSegment / 4; ++w) qs[w] = qw[w];
      int key = 0, run = 0;  // the rolling key and its run of ACGT codes
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned c = (codes[0] >> (8 * k)) & 0xffu;
        key = ((key << 2) | (c & 3)) & (kKmerKeys - 1);
        run = c & 0x80 ? 0 : run + 1;
      }
      int q_bin = -1, q_n = 0;
#pragma unroll
      for (int j = 0; j < kSegment; ++j) {
        const unsigned c = (codes[(j + 4) / 4] >> (8 * ((j + 4) % 4))) & 0xffu;
        key = ((key << 2) | (c & 3)) & (kKmerKeys - 1);
        run = c & 0x80 ? 0 : run + 1;
        if (p0 + j < end) {
          const int bin = min(static_cast<int>((qs[j / 4] >> (8 * (j % 4))) & 0xffu),
                              kQualBins - 1);
          if (bin != q_bin) {
            if (q_n) atomicAdd(&s_qual[q_bin], q_n);
            q_bin = bin;
            q_n = 0;
          }
          ++q_n;
          if (run >= 5 && p0 + j >= 4) atomicAdd(&s_kmer[key], 1);
        }
      }
      if (q_n) atomicAdd(&s_qual[q_bin], q_n);
    }
  }
  __syncthreads();
  PHASE(3);  // histograms

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sums are made
  PHASE(4);
  // each block of the cluster sums one slice of the sums over the cluster's
  // blocks (distributed shared memory; packed counts field by field) and
  // adds the non-zero ones to the accumulator
  const int rank = cluster.block_rank();
  const int blocks = cluster.num_blocks();
  const int per = (kSums + blocks - 1) / blocks;
  const long long tail = static_cast<long long>(kSlotValues) * L;
  for (int i = rank * per + tid; i < min(kSums, (rank + 1) * per); i += kThreads) {
    int v = 0, v1 = 0, v2 = 0;
    for (int k = 0; k < blocks; ++k) {
      const int x = cluster.map_shared_rank(s_sums, k)[i];
      if (i < kSlots * kTile) {
        v += x & 1023;
        v1 += (x >> 10) & 1023;
        v2 += x >> 20;
      } else {
        v += x;
      }
    }
    if (i < 2 * kSlots * kTile) {
      const int slot = (i / kTile) % kSlots, pc = c0 + i % kTile;
      if (pc >= L) continue;
      long long* at = acc + static_cast<long long>(slot) * L + pc;
      if (i < kSlots * kTile) {  // content, q20, q30
        if (v) add_int64(at, v);
        if (v1) add_int64(at + kSlots * static_cast<long long>(L), v1);
        if (v2) add_int64(at + 2 * kSlots * static_cast<long long>(L), v2);
      } else if (v) {            // the quality sum
        add_int64(at + 3 * kSlots * static_cast<long long>(L), v);
      }
    } else if (v) {
      add_int64(acc + tail + (i - 2 * kSlots * kTile), v);
    }
  }
  PHASE(5);  // slice sums, accumulator
  __threadfence();
  __syncthreads();
  unsigned long long* ticket =
      reinterpret_cast<unsigned long long*>(acc + tail + kQualBins + kKmerKeys + 2);
  if (tid == 0)
    s_last = atomicAdd(ticket, 1ull) == static_cast<unsigned long long>(launched - 1);
  PHASE(6);  // fence, ticket
  cluster.sync();  // the slices are read; each block knows whether it was last
  PHASE(7);
  bool last = false;
  for (int k = 0; k < blocks; ++k) last |= *cluster.map_shared_rank(&s_last, k);
  // the last cluster, all its blocks: every value of the output, loads
  // four at a time, then the accumulator and the ticket back to 0
  const long long stride = static_cast<long long>(blocks) * kThreads;
  const long long me = static_cast<long long>(rank) * kThreads + tid;
  if (last) {
    __threadfence();
    const long long n_out = static_cast<long long>(kSlotValues + 2) * L + kQualBins +
                            kKmerBins + 2;
    for (long long base = me; base < n_out; base += 4 * stride) {
      long long v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = base + k * stride;
        v[k] = i < n_out ? output_value(acc, i, L) : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (base + k * stride < n_out) out[base + k * stride] = v[k];
    }
  }
  cluster.sync();  // every block has read s_last, the last cluster the sums
  PHASE(8);  // the output
  if (last)
    for (long long i = me; i < tail + kQualBins + kKmerKeys + 3; i += stride) acc[i] = 0;
  PHASE(9);  // zeroing
}

}  // namespace

// Launches on `stream` without synchronising; returns the launch's CUDA
// error, or cudaErrorInvalidValue for a geometry the kernel cannot count in.
// The grid is ceil(L / 32) column tiles x `chunks` chunks of `rows_per_block`
// (<= 128) rows, in clusters of `cluster` (1 to 8, dividing `chunks`) chunks
// of one tile.  `acc` holds kSlotValues * L + 128 + 1024 + 3 int64, zero
// before the first launch (the last is the ticket); every launch leaves it
// zero.  `out` holds 34 * L + 128 + 2048 + 2 int64, all written.
extern "C" int stat_batch(const void* bases, const void* quals,
                          const void* lengths, const void* include, int B,
                          int L, int rows_per_block, int chunks, int cluster,
                          void* acc, void* out, void* stream) {
  if (B <= 0) return 0;
  const int tiles = L > 0 ? (L + kTile - 1) / kTile : 1;
  if (rows_per_block <= 0 || rows_per_block > kMaxRows || chunks <= 0 ||
      chunks > 65535 || cluster < 1 || cluster > kMaxCluster ||
      chunks % cluster != 0 ||
      static_cast<long long>(rows_per_block) * chunks < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vector_loads = L % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(bases) % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(quals) % 16 == 0;
  static const cudaError_t carveout = cudaFuncSetAttribute(
      stat_batch_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles, chunks, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, stat_batch_kernel, static_cast<const uint8_t*>(bases),
      static_cast<const uint8_t*>(quals), static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(include), B, L, rows_per_block, tiles * chunks,
      vector_loads, static_cast<long long*>(acc), static_cast<long long*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
