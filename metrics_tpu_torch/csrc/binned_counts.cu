// Binned threshold counting for the binned-curve metrics, hand-written for Hopper (sm_90a).
//
//   tp[t] = sum_n pos[n] * (preds[n] >= thr[t])
//   fp[t] = sum_n neg[n] * (preds[n] >= thr[t])
//
// Replaces the Pallas TPU kernel metrics_tpu/ops/binned.py:_binned_counts_pallas_binary
// (body _binary_kernel), which streams N through VMEM and contracts the (tile, T) comparison
// matrix against the weights on the MXU, carrying the (8, T) sum across a grid that the TPU
// runs in order.
//
// What bounds it on the H100: memory. The function reads each score and weight once
// (N * (4 + 1 + 1) bytes for 0/1 weights) and writes 2 * T floats; at 3.35 TB/s that is the
// floor. The direct O(N * T) compare-and-count would instead be bound by ~2 * N * T integer
// operations, a hundred times the byte floor at N = 4M, T = 2048.
//
// The design removes the T factor: bucketize, histogram, suffix sum.
//   1. rank_thresholds: the thresholds are not guaranteed ascending (a user list is never
//      sorted), so each threshold's position in a total order (NaN last, ties by index) is
//      computed by one block counting the thresholds before it. This sorts them with their
//      permutation, duplicates included.
//   2. histogram: each sample's bin is the number of sorted thresholds <= its score (a binary
//      search in shared memory); the sample adds its weights to that bin. A sample with score
//      p reaches exactly the sorted thresholds below its bin, so NaN (no threshold <= NaN)
//      lands in bin 0 and counts nowhere, -inf reaches only -inf thresholds, +inf reaches all.
//      Blocks run in parallel in no order (unlike the TPU grid), so each block keeps a private
//      histogram in shared memory and folds it into the global one with atomics at the end.
//   3. suffix_scatter: count_sorted[k] = sum of bins k+1..T (a block-wide suffix scan), written
//      back through the permutation as float32.
// 0/1 (bool) weights count in uint32, exact below 2^32 and exact in the float32 output below
// 2^24 per call, the contract of the JAX kernel. Float weights accumulate in float64 atomics,
// so only the order of the sum differs from the plain version.
//
// The C entry launches on the caller's stream, never synchronises, allocates nothing (the
// Python wrapper passes zeroed scratch), and returns the first cudaGetLastError() that is not
// cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRankThreads = 256;
constexpr int kHistThreads = 512;
constexpr int kScanThreads = 1024;

// total order on (value, index): numbers ascending, NaN after every number, ties by index
__device__ __forceinline__ bool ordered_before(float a, int ia, float b, int ib) {
  const bool a_nan = isnan(a), b_nan = isnan(b);
  if (a_nan || b_nan) return (a_nan && b_nan) ? ia < ib : b_nan;
  return a < b || (a == b && ia < ib);
}

// one block per threshold: its rank in the total order is its sorted position
__global__ void __launch_bounds__(kRankThreads)
rank_thresholds(const float* __restrict__ thr, int t, float* __restrict__ sorted, int* __restrict__ perm) {
  const int i = blockIdx.x;
  const float v = thr[i];
  unsigned int before = 0;
  for (int j = threadIdx.x; j < t; j += kRankThreads) before += ordered_before(thr[j], j, v, i) ? 1u : 0u;
  for (int off = 16; off > 0; off >>= 1) before += __shfl_down_sync(0xffffffffu, before, off);
  __shared__ unsigned int warp_sums[kRankThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = before;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int rank = 0;
    for (int w = 0; w < kRankThreads / 32; ++w) rank += warp_sums[w];
    sorted[rank] = v;
    perm[rank] = i;
  }
}

// number of sorted thresholds s[k] with s[k] <= p (NaN thresholds sit last and never compare true)
__device__ __forceinline__ int upper_bound(const float* s, int t, float p) {
  int lo = 0, hi = t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// hist holds 2 * (t + 1) accumulators: the tp bins, then the fp bins.
// With use_smem the block keeps its own copy of the bins and the sorted thresholds in shared
// memory; otherwise (thresholds too many for shared memory) it searches and counts in global.
template <typename W, typename A>
__global__ void __launch_bounds__(kHistThreads)
histogram(const float* __restrict__ preds, const W* __restrict__ pos, const W* __restrict__ neg, long long n,
          const float* __restrict__ sorted, int t, A* __restrict__ hist, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = t + 1;
  const float* s_thr = sorted;
  A* h = hist;
  if (use_smem) {
    A* sh = reinterpret_cast<A*>(smem_raw);
    float* st = reinterpret_cast<float*>(sh + 2 * nb);
    for (int k = threadIdx.x; k < 2 * nb; k += kHistThreads) sh[k] = A(0);
    for (int k = threadIdx.x; k < t; k += kHistThreads) st[k] = sorted[k];
    __syncthreads();
    s_thr = st;
    h = sh;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kHistThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kHistThreads + threadIdx.x; i < n; i += stride) {
    const A wp = static_cast<A>(pos[i]);
    const A wn = static_cast<A>(neg[i]);
    if (wp == A(0) && wn == A(0)) continue;
    const int bin = upper_bound(s_thr, t, preds[i]);
    if (wp != A(0)) atomicAdd(&h[bin], wp);
    if (wn != A(0)) atomicAdd(&h[nb + bin], wn);
  }
  if (use_smem) {
    __syncthreads();
    for (int k = threadIdx.x; k < 2 * nb; k += kHistThreads) {
      const A v = h[k];
      if (v != A(0)) atomicAdd(&hist[k], v);
    }
  }
}

// block 0 scans the tp bins, block 1 the fp bins: out[perm[k]] = sum of bins k+1..t
template <typename A>
__global__ void __launch_bounds__(kScanThreads)
suffix_scatter(const A* __restrict__ hist, int t, const int* __restrict__ perm,
               float* __restrict__ out_tp, float* __restrict__ out_fp) {
  const int nb = t + 1;
  const A* h = hist + static_cast<long long>(blockIdx.x) * nb;
  float* out = blockIdx.x == 0 ? out_tp : out_fp;
  const int chunk = (nb + kScanThreads - 1) / kScanThreads;
  const int begin = min(nb, static_cast<int>(threadIdx.x) * chunk);
  const int end = min(nb, begin + chunk);
  A local = A(0);
  for (int j = begin; j < end; ++j) local += h[j];

  // inclusive suffix scan of the per-thread chunk sums (Hillis-Steele)
  __shared__ A part[kScanThreads];
  part[threadIdx.x] = local;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const A v = (threadIdx.x + off < kScanThreads) ? part[threadIdx.x + off] : A(0);
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  // walk the chunk right to left: after adding bin j, running = sum of bins j..t = count_sorted[j - 1]
  A running = (threadIdx.x + 1 < kScanThreads) ? part[threadIdx.x + 1] : A(0);
  for (int j = end - 1; j >= begin; --j) {
    running += h[j];
    if (j >= 1) out[perm[j - 1]] = static_cast<float>(running);
  }
}

template <typename W, typename A>
int launch(const float* preds, const void* pos, const void* neg, long long n, const float* thr, int t,
           float* sorted, int* perm, void* hist_raw, float* out_tp, float* out_fp, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  rank_thresholds<<<t, kRankThreads, 0, stream>>>(thr, t, sorted, perm);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  A* hist = static_cast<A*>(hist_raw);
  const size_t smem = 2 * static_cast<size_t>(t + 1) * sizeof(A) + static_cast<size_t>(t) * sizeof(float);
  int smem_optin = 0, sms = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int use_smem = smem <= static_cast<size_t>(smem_optin) ? 1 : 0;
  const size_t dyn_smem = use_smem ? smem : 0;
  if (dyn_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(histogram<W, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram<W, A>, kHistThreads, dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two resident blocks per SM at most: every block folds 2 * (t + 1) bins into global with atomics
  const long long want = (n + kHistThreads - 1) / kHistThreads;
  const long long cap = static_cast<long long>(sms) * (per_sm < 2 ? (per_sm < 1 ? 1 : per_sm) : 2);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  histogram<W, A><<<blocks, kHistThreads, dyn_smem, stream>>>(
      preds, static_cast<const W*>(pos), static_cast<const W*>(neg), n, sorted, t, hist, use_smem);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  suffix_scatter<A><<<2, kScanThreads, 0, stream>>>(hist, t, perm, out_tp, out_fp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// weight_kind 0: pos/neg are 0/1 bytes (torch.bool), hist is 2 * (t + 1) uint32, zeroed.
// weight_kind 1: pos/neg are float32, hist is 2 * (t + 1) float64, zeroed.
// sorted (t float32) and perm (t int32) are scratch. Requires n > 0 and t > 0.
int mtt_binned_counts(const float* preds, const void* pos, const void* neg, long long n, const float* thr, int t,
                      int weight_kind, float* sorted, int* perm, void* hist, float* out_tp, float* out_fp,
                      int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight_kind == 0)
    return launch<uint8_t, unsigned int>(preds, pos, neg, n, thr, t, sorted, perm, hist, out_tp, out_fp, device, s);
  if (weight_kind == 1)
    return launch<float, double>(preds, pos, neg, n, thr, t, sorted, perm, hist, out_tp, out_fp, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
