// PE overlap sweep with first-accept selection, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel fastp_tpu/ops/overlap_pallas.py:_mm_kernel (the
// [n_off, B] mismatch matrices mm and mm50, launched twice per batch) together
// with its consumer fastp_tpu/ops/overlap.py:_select_first_accept.  Here no
// [B, n_off] matrix reaches device memory: each pair row walks its offsets
// in the reference's order and stops at the first accepted one, which gives
// the same answer as the full sweep because the first accept wins.
//
// For pair row r, forward offset t (t < len1 - overlap_require):
//   olen = min(len1 - t, len2), compare seq1[t + i] with rc2[i] for i < olen;
// then backward offsets k = 0, 1, ... (k < len2 - overlap_require):
//   olen = min(len1, len2 - k), compare rc2[k + i] with seq1[i], offset = -k.
// An offset is accepted when mm50 <= limit and (mm <= limit or olen > 50),
// with limit = min(diff_limit, (int)(float(olen) * diff_pct)) in float32.
//
// Design: one warp per pair row; the row's two byte strings (2 L bytes) are
// staged in shared memory; the lanes split the positions of one offset, a
// warp reduction sums the two mismatch counts, and the accept test is
// warp-uniform, so the whole warp breaks together.
//
// What bounds it on the card: per batch (B = 8192, L = 160) at most
// 8192 x 2 x 130 x 160 ~ 340 M byte compares over 2.6 MB of input, and far
// fewer with the early stop.  That is well under a millisecond of either
// bandwidth or issue rate, so latency (the serial offset walk per row) and the
// launch itself dominate, not memory bandwidth.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCompleteCompareRequire = 50;

__device__ __forceinline__ int limit_of(int olen, int diff_limit, float diff_pct) {
  const int oc = olen > 0 ? olen : 0;
  const int lim = static_cast<int>(__fmul_rn(static_cast<float>(oc), diff_pct));
  return lim < diff_limit ? lim : diff_limit;
}

// Mismatches a[i] != b[i] over i < olen (total) and over i < 50 (pre50),
// summed across the warp; every lane gets both sums.
__device__ __forceinline__ void count_mismatch(const uint8_t* a, const uint8_t* b,
                                               int olen, int lane,
                                               int* total, int* pre50) {
  unsigned t = 0, p = 0;
  for (int i = lane; i < olen; i += 32) {
    const unsigned m = a[i] != b[i];
    t += m;
    p += (i < kCompleteCompareRequire) ? m : 0u;
  }
  *total = static_cast<int>(__reduce_add_sync(0xffffffffu, t));
  *pre50 = static_cast<int>(__reduce_add_sync(0xffffffffu, p));
}

__global__ void overlap_sweep_kernel(const uint8_t* __restrict__ seq1,
                                     const uint8_t* __restrict__ rc2,
                                     const int32_t* __restrict__ len1,
                                     const int32_t* __restrict__ len2,
                                     int B, int L, int diff_limit,
                                     int overlap_require, float diff_pct,
                                     bool* __restrict__ overlapped,
                                     int32_t* __restrict__ offset,
                                     int32_t* __restrict__ overlap_len,
                                     int32_t* __restrict__ diff) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // warp-uniform

  uint8_t* a = smem + static_cast<size_t>(warp) * 2 * L;
  uint8_t* b = a + L;
  const uint8_t* s1 = seq1 + static_cast<size_t>(row) * L;
  const uint8_t* s2 = rc2 + static_cast<size_t>(row) * L;
  for (int i = lane; i < L; i += 32) {
    a[i] = s1[i];
    b[i] = s2[i];
  }
  __syncwarp();

  // lengths lie in [0, L] for every caller; clamp so a bad one cannot read
  // outside the staged row
  const int l1 = min(max(len1[row], 0), L);
  const int l2 = min(max(len2[row], 0), L);

  bool found = false;
  int off = 0, ol = 0, df = 0;
  for (int t = 0; t < l1 - overlap_require; ++t) {
    const int olen = min(l1 - t, l2);
    int total, pre50;
    count_mismatch(a + t, b, olen, lane, &total, &pre50);
    const int lim = limit_of(olen, diff_limit, diff_pct);
    if (pre50 <= lim && (total <= lim || olen > kCompleteCompareRequire)) {
      found = true;
      off = t;
      ol = olen;
      df = total;
      break;
    }
  }
  if (!found) {
    for (int k = 0; k < l2 - overlap_require; ++k) {
      const int olen = min(l1, l2 - k);
      int total, pre50;
      count_mismatch(b + k, a, olen, lane, &total, &pre50);
      const int lim = limit_of(olen, diff_limit, diff_pct);
      if (pre50 <= lim && (total <= lim || olen > kCompleteCompareRequire)) {
        found = true;
        off = -k;
        ol = olen;
        df = total;
        break;
      }
    }
  }
  if (lane == 0) {
    overlapped[row] = found;
    offset[row] = off;
    overlap_len[row] = ol;
    diff[row] = df;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int overlap_sweep(const void* seq1, const void* rc2, const void* len1,
                             const void* len2, int B, int L, int diff_limit,
                             int overlap_require, float diff_pct,
                             void* overlapped, void* offset, void* overlap_len,
                             void* diff, int warps_per_block, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + warps_per_block - 1) / warps_per_block;
  const size_t smem = static_cast<size_t>(warps_per_block) * 2 * L;
  overlap_sweep_kernel<<<grid, warps_per_block * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq1), static_cast<const uint8_t*>(rc2),
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2), B, L,
      diff_limit, overlap_require, diff_pct, static_cast<bool*>(overlapped),
      static_cast<int32_t*>(offset), static_cast<int32_t*>(overlap_len),
      static_cast<int32_t*>(diff));
  return static_cast<int>(cudaGetLastError());
}
