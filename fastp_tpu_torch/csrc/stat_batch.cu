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
// into the plain version's dict).
//
// What bounds it on the card.  A main-path call (B = 8192, L = 160) reads
// 2.6 MB and writes 45 KB: 0.81 us at 3.35 TB/s.  The integer work needs at
// least about 12 operations per base of an included read (slot, quality,
// two thresholds, a packed count and a quality sum, the quality bin, a
// rolling 5-mer key and its count), 12 M operations, 0.74 us on the integer
// pipes at 1.98 GHz: bytes bound it, the operations close behind, and what
// a kernel loses beyond them is serial contention on histogram bins, the
// flush of each block's sums to device memory, and the launch.
//
// What the design does about it:
//  * One pass over the bytes, loads coalesced.  A block owns one tile of 32
//    cycle columns and a chunk of rows; its eight warps walk the chunk's rows
//    in turn, lane c of a warp taking column c of the tile, so a warp reads
//    32 consecutive bytes of one row.  The four bases before p that a 5-mer
//    needs are read again from L1; p >= 4 keeps them inside the row.
//  * The 8 x 4 slot-channel sums stay in registers.  A register cannot be
//    indexed by the slot, so the slot selects with eight predicated adds,
//    and the three counts of a slot share one 32-bit register as 10-bit
//    fields (a thread walks at most 1,023 rows: the wrapper's geometry keeps
//    a chunk under 1,023 rows per warp), the quality sum another.
//  * Histograms in shared memory, int32.  The quality histogram takes one
//    shared atomic per distinct bin of a warp's 32 positions
//    (__match_any_sync): binned qualities put a whole warp in two or three
//    bins, and 32 atomics on one address would serialise.  The 1024 5-mer
//    bins spread a warp's keys, so each lane adds its own.
//  * One flush per block.  The warps' registers meet in shared memory, and
//    every non-zero sum goes to device memory with one 64-bit atomicAdd.  The
//    quality sums can be negative (qual < 33): they are added sign-extended,
//    as two's complement through unsigned long long, which the int64 result
//    reads back exactly.  Only the first column tile counts reads and
//    length_sum.
//  * Nothing in shared memory grows with L (8,960 bytes a block): any width
//    is a number of column tiles.  The grid is tiles x chunks, about two
//    blocks per SM of the H100's 132 (the wrapper picks the chunk), so the
//    flush's atomics are a few hundred per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;
constexpr int kSlots = 8;
constexpr int kQualBins = 128;
constexpr int kKmerKeys = 1024;
constexpr int kKmerBins = 2048;
constexpr int kQ20 = '5';
constexpr int kQ30 = '?';
constexpr unsigned kFullMask = 0xffffffffu;
// per column: 8 slots x (content, q20, q30, qual), then total base and qual;
// value j of column p lies at out[j * L + p]
constexpr int kColumnValues = 4 * kSlots + 2;
constexpr int kMaxRowsPerThread = 1023;  // a 10-bit field

// A=0 T=1 C=2 G=3, any other byte -1 (src/stats.cpp:334-347)
__device__ __forceinline__ int base2val(unsigned b) {
  return b == 'A' ? 0 : b == 'T' ? 1 : b == 'C' ? 2 : b == 'G' ? 3 : -1;
}

__device__ __forceinline__ void add_int64(long long* dst, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            static_cast<unsigned long long>(v));
}

__global__ void __launch_bounds__(kWarps * 32)
stat_batch_kernel(const uint8_t* __restrict__ bases,
                  const uint8_t* __restrict__ quals,
                  const int32_t* __restrict__ lengths,
                  const uint8_t* __restrict__ include, int B, int L,
                  int rows_per_block, long long* __restrict__ out) {
  __shared__ int s_column[kColumnValues][kTile];
  __shared__ int s_qual[kQualBins];
  __shared__ int s_kmer[kKmerKeys];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int i = tid; i < kColumnValues * kTile; i += blockDim.x)
    (&s_column[0][0])[i] = 0;
  for (int i = tid; i < kQualBins; i += blockDim.x) s_qual[i] = 0;
  for (int i = tid; i < kKmerKeys; i += blockDim.x) s_kmer[i] = 0;
  __syncthreads();

  const int p = blockIdx.x * kTile + lane;
  const bool column = p < L;
  const bool counts_reads = blockIdx.x == 0 && lane == 0;
  const int row0 = blockIdx.y * rows_per_block;
  const int row1 = min(row0 + rows_per_block, B);

  unsigned packed[kSlots];  // content | q20 << 10 | q30 << 20
  int qual_sum[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    packed[s] = 0u;
    qual_sum[s] = 0;
  }
  int total_base = 0, total_qual = 0;
  long long reads = 0, length_sum = 0;

  // warp-uniform: every lane of a warp walks the same rows
  for (int r = row0 + warp; r < row1; r += kWarps) {
    const int rlen = lengths[r];
    const bool inc = include[r] != 0;
    if (counts_reads && inc) {
      ++reads;
      length_sum += rlen;
    }
    int qbin = -1, key = -1;
    if (inc && column && p < rlen) {
      const uint8_t* row = bases + static_cast<size_t>(r) * L;
      const unsigned b = row[p];
      const int q = quals[static_cast<size_t>(r) * L + p];
      const int slot = static_cast<int>(b & 7u);
      const int qm33 = q - 33;
      const unsigned add = 1u | (static_cast<unsigned>(q >= kQ20) << 10) |
                           (static_cast<unsigned>(q >= kQ30) << 20);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (slot == s) {
          packed[s] += add;
          qual_sum[s] += qm33;
        }
      }
      ++total_base;
      total_qual += qm33;
      qbin = min(q, kQualBins - 1);
      if (p >= 4) {
        int k = base2val(b);
#pragma unroll
        for (int back = 1; back <= 4; ++back) {
          const int v = base2val(row[p - back]);
          k = (k < 0 || v < 0) ? -1 : k + (v << (2 * back));
        }
        key = k;
      }
    }
    const unsigned peers = __match_any_sync(kFullMask, qbin);
    if (qbin >= 0 && __ffs(peers) - 1 == lane) atomicAdd(&s_qual[qbin], __popc(peers));
    if (key >= 0) atomicAdd(&s_kmer[key], 1);
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (packed[s]) {
      atomicAdd(&s_column[s][lane], static_cast<int>(packed[s] & 1023u));
      atomicAdd(&s_column[kSlots + s][lane], static_cast<int>((packed[s] >> 10) & 1023u));
      atomicAdd(&s_column[2 * kSlots + s][lane], static_cast<int>(packed[s] >> 20));
      atomicAdd(&s_column[3 * kSlots + s][lane], qual_sum[s]);
    }
  }
  if (total_base) {
    atomicAdd(&s_column[4 * kSlots][lane], total_base);
    atomicAdd(&s_column[4 * kSlots + 1][lane], total_qual);
  }
  const long long tail = static_cast<long long>(kColumnValues) * L + kQualBins + kKmerBins;
  if (counts_reads && reads) {
    add_int64(out + tail, reads);
    add_int64(out + tail + 1, length_sum);
  }
  __syncthreads();

  for (int i = tid; i < kColumnValues * kTile; i += blockDim.x) {
    const int v = (&s_column[0][0])[i];
    const int pc = blockIdx.x * kTile + i % kTile;
    if (v != 0 && pc < L) add_int64(out + static_cast<long long>(i / kTile) * L + pc, v);
  }
  long long* qual_hist = out + static_cast<long long>(kColumnValues) * L;
  for (int i = tid; i < kQualBins; i += blockDim.x)
    if (s_qual[i]) add_int64(qual_hist + i, s_qual[i]);
  long long* kmer = qual_hist + kQualBins;
  for (int i = tid; i < kKmerKeys; i += blockDim.x)
    if (s_kmer[i]) add_int64(kmer + i, s_kmer[i]);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernel cannot count in (more than
// 1,023 rows per warp, or more chunks than a grid's second dimension holds).
// `out` holds kColumnValues * L + 128 + 2048 + 2 int64, zeroed by the caller;
// the grid is ceil(L / 32) column tiles x `chunks` chunks of
// `rows_per_block` rows.
extern "C" int stat_batch(const void* bases, const void* quals,
                          const void* lengths, const void* include, int B,
                          int L, int rows_per_block, int chunks, void* out,
                          void* stream) {
  if (B <= 0) return 0;
  const int tiles = L > 0 ? (L + kTile - 1) / kTile : 1;
  if (rows_per_block <= 0 || chunks <= 0 || chunks > 65535 ||
      (rows_per_block + kWarps - 1) / kWarps > kMaxRowsPerThread ||
      static_cast<long long>(rows_per_block) * chunks < B)
    return static_cast<int>(cudaErrorInvalidValue);
  stat_batch_kernel<<<dim3(tiles, chunks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
      static_cast<const int32_t*>(lengths), static_cast<const uint8_t*>(include),
      B, L, rows_per_block, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
