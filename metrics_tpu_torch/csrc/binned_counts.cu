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
// The design removes the T factor (bucketize, histogram, suffix sum) in ONE launch per call:
//   * The grid comes ranked: `sorted` ascending with NaN last and `perm` with
//     sorted[k] == thr[perm[k]]. The binned metrics rank it once per grid (torch.sort, stable);
//     the wrapper ranks it for a call that does not pass it.
//   * Each block stages the sorted grid in shared memory and builds a bucket table over the
//     finite grid's range: bucket(p) = floor((p - lo) * m / (hi - lo)) clamped to [0, m),
//     a monotone function of p, and tab[b] = #{k : bucket(s[k]) < b}. A score's bin
//     #{k : s[k] <= p} then lies in [tab[b], tab[b + 1]) for b = bucket(p), and a binary search
//     of that bracket (0-2 steps on an even grid) settles it with exact s[k] <= p comparisons.
//     The bracket holds whatever rounding does to bucket(), so the bin stays exact for -0/+0,
//     subnormals, ties and +-inf; NaN compares false everywhere and lands in bin 0 (counted
//     nowhere). A plain 11-step search of 2,048 floats probes multiples of 32 floats at its
//     middle levels, all in one shared-memory bank; the table lookups fall on random banks.
//   * Scores are read as float4 and weights 4 at a time. A thread buckets its 4 scores in
//     lockstep (4 independent lookups) while the loads of its next two vectors are in flight;
//     its first two are requested before the block builds its table. A scalar head and tail
//     cover an unaligned data_ptr and an N that is not a multiple of 4.
//   * 0/1 weights add one 32-bit shared atomic per sample whose pos or neg is set (two when both
//     are; a binary target sets exactly one), into separate tp and fp bins: on the H100 a 64-bit
//     shared atomic of the packed pair pos | neg << 32 costs more than one 32-bit atomic. Float
//     weights add float64.
//   * The blocks of a 2-block cluster sum their histograms through distributed shared memory,
//     each block half of the bins, and only nonzero sums reach the global accumulator:
//     2 * (T + 1) atomics per cluster in place of 2 * (T + 1) per block.
//   * The last block to finish (a __threadfence + atomic ticket) stages the accumulator past L1
//     (the other SMs' atomics wrote it in L2) and `perm`, takes the suffix sums,
//     writes count_sorted[k] = sum of bins k+1..T through `perm` as float32, and zeroes the
//     accumulator and the ticket, so the next call on the stream finds them zeroed. The
//     output is written whole: no fill runs before the kernel.
//   * Grids too large for shared memory (the sorted grid plus the bins above ~227 KB) take the
//     same kernel with the search in global memory and atomics straight into the accumulator.
//
// The C entry launches on the caller's stream, never synchronises, allocates nothing, queries
// device attributes and occupancy once per device and grid size (a static cache), and returns
// the first CUDA error code that is not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

// One 1,024-thread block an SM (50% occupancy, up to 64 registers a thread): every block builds
// its own bucket table, so this builds one table an SM where 3 blocks of 512 threads (75%) build
// three, and that setup sits on the critical path; two vectors in flight a thread keep the loads
// deep at this occupancy.
constexpr int kThreads = 1024;
constexpr int kMinBlocksPerSm = 1;
// Clusters of 2 blocks: the card's GPCs place one on every pair of SMs, where larger clusters
// leave SMs of some GPCs idle.
constexpr int kCluster = 2;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------------------------
// weights: how a sample's pair (pos, neg) is loaded and added to its bin

__device__ __forceinline__ float lane4(float4 v, int i) { return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w)); }

template <typename W>
struct Weights;

template <>
struct Weights<uint8_t> {  // torch.bool, exact integer counts below 2^32
  using Acc = unsigned int;
  using Vec = unsigned int;  // 4 weights
  static constexpr int kSlots = 2;  // tp bins, then fp bins
  static constexpr uintptr_t kVecAlign = 4;
  static __device__ __forceinline__ Vec load4(const uint8_t* p) { return __ldcs(reinterpret_cast<const Vec*>(p)); }
  static __device__ __forceinline__ unsigned int lane(Vec v, int i) { return (v >> (8 * i)) & 0xffu; }
  static __device__ __forceinline__ unsigned int load1(const uint8_t* p) { return *p; }
  template <typename P>
  static __device__ __forceinline__ void add(Acc* h, int nb, int bin, P wp, P wn) {
    if (wp) atomicAdd(h + bin, static_cast<Acc>(wp));
    if (wn) atomicAdd(h + nb + bin, static_cast<Acc>(wn));
  }
};

template <>
struct Weights<float> {  // float32 weights, float64 accumulation
  using Acc = double;
  using Vec = float4;
  static constexpr int kSlots = 2;  // tp bins, then fp bins
  static constexpr uintptr_t kVecAlign = 16;
  static __device__ __forceinline__ Vec load4(const float* p) { return __ldcs(reinterpret_cast<const Vec*>(p)); }
  static __device__ __forceinline__ float lane(Vec v, int i) { return lane4(v, i); }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  template <typename P>
  static __device__ __forceinline__ void add(Acc* h, int nb, int bin, P wp, P wn) {
    if (wp != 0.f) atomicAdd(h + bin, static_cast<double>(wp));
    if (wn != 0.f) atomicAdd(h + nb + bin, static_cast<double>(wn));
  }
};

// ---------------------------------------------------------------------------------------------
// bucketing

// monotone in p (round-to-nearest subtract and multiply, no contraction); NaN -> 0, +inf -> m - 1
__device__ __forceinline__ int bucket(float p, float lo, float inv_w, int m) {
  const float x = __fmul_rn(__fsub_rn(p, lo), inv_w);
  return x > 0.f ? (x < static_cast<float>(m - 1) ? static_cast<int>(x) : m - 1) : 0;
}

// #{k in [l, h) : s[k] <= p} + l, for s ascending on [l, h)
__device__ __forceinline__ int search(const float* s, int l, int h, float p) {
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (s[mid] <= p) l = mid + 1; else h = mid;
  }
  return l;
}

struct Grid {
  const float* s;  // sorted thresholds (shared memory, or global on the large-grid route)
  const int* tab;  // bucket table, m + 1 entries (shared-memory route only)
  int t, m;
  float lo, inv_w;
};

// the bracket [l, r) that holds p's bin
template <bool kSmem>
__device__ __forceinline__ void bracket(const Grid& g, float p, int& l, int& r) {
  if constexpr (kSmem) {
    const int b = bucket(p, g.lo, g.inv_w, g.m);
    l = g.tab[b];
    r = g.tab[b + 1];
  } else {
    l = 0;
    r = g.t;
  }
}

// bin of one score: #{k : s[k] <= p}
template <bool kSmem>
__device__ __forceinline__ int find_bin(const Grid& g, float p) {
  int l, r;
  bracket<kSmem>(g, p, l, r);
  return search(g.s, l, r, p);
}

// four scores with their weights: the four brackets are looked up, then searched in lockstep,
// so their shared-memory loads are independent and overlap
template <typename WT, bool kSmem>
__device__ __forceinline__ void count4(const Grid& g, typename WT::Acc* h, int nb, float4 p, typename WT::Vec wp,
                                       typename WT::Vec wn) {
  int l[4], r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bracket<kSmem>(g, lane4(p, e), l[e], r[e]);
  for (;;) {
    bool more = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (l[e] < r[e]) {
        const int mid = (l[e] + r[e]) >> 1;
        if (g.s[mid] <= lane4(p, e)) l[e] = mid + 1; else r[e] = mid;
        more = true;
      }
    }
    if (!more) break;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) WT::add(h, nb, l[e], WT::lane(wp, e), WT::lane(wn, e));
}

// ---------------------------------------------------------------------------------------------
// the last block: suffix sums, scatter through perm, zero the accumulator

// asynchronous copies from global to shared memory (cp.async, no register round trip): 4 or 8 bytes
// through L1 (.ca), or 16 bytes from L2 alone (.cg) for data other SMs wrote in this launch
template <typename V>
__device__ __forceinline__ void copy_async(V* smem_dst, const V* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src), "n"(sizeof(V)) : "memory");
}

__device__ __forceinline__ void copy_async_l2(uint4* smem_dst, const uint4* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

// out[perm[k]] = the sum of the tp bins k+1..t, and out[t + perm[k]] the same of the fp bins; the
// tp bins are acc[0..t], the fp bins acc[t+1..2t+1]. Both are scanned in one pass: each thread
// sums a chunk, the warps scan the chunk sums with shuffles, and each thread walks its chunk back.
// kGlobal: acc lies in global memory, is read past L1 and left zero; otherwise in shared memory.
template <bool kGlobal, typename V>
__device__ void finish(V* acc, int t, const int* perm, float* __restrict__ out) {
  __shared__ __align__(8) unsigned char warp_raw[2 * kWarps * 8];
  V* warp_tp = reinterpret_cast<V*>(warp_raw);
  V* warp_fp = warp_tp + kWarps;
  const int nb = t + 1;
  V* tp_bins = acc;
  V* fp_bins = acc + nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = (nb + kThreads - 1) / kThreads;
  const int begin = min(nb, static_cast<int>(threadIdx.x) * chunk);
  const int end = min(nb, begin + chunk);
  auto load = [&](const V* bins, int j) {
    if constexpr (kGlobal) return __ldcg(bins + j); else return bins[j];
  };
  V a = V(0), b = V(0);
#pragma unroll 4
  for (int j = begin; j < end; ++j) {
    a += load(tp_bins, j);
    b += load(fp_bins, j);
  }
  for (int off = 1; off < 32; off <<= 1) {  // inclusive suffix sums over the warp's lanes
    const V ya = __shfl_down_sync(0xffffffffu, a, off);
    const V yb = __shfl_down_sync(0xffffffffu, b, off);
    if (lane + off < 32) {
      a += ya;
      b += yb;
    }
  }
  if (lane == 0) {
    warp_tp[warp] = a;
    warp_fp[warp] = b;
  }
  __syncthreads();
  V ra = __shfl_down_sync(0xffffffffu, a, 1);  // the bins after this thread's chunk
  V rb = __shfl_down_sync(0xffffffffu, b, 1);
  if (lane == 31) ra = rb = V(0);
  for (int w = warp + 1; w < kWarps; ++w) {
    ra += warp_tp[w];
    rb += warp_fp[w];
  }
  for (int j = end - 1; j >= begin; --j) {
    ra += load(tp_bins, j);
    rb += load(fp_bins, j);
    if (j >= 1) {
      const int i = perm[j - 1];
      out[i] = static_cast<float>(ra);
      out[t + i] = static_cast<float>(rb);
    }
    if constexpr (kGlobal) tp_bins[j] = fp_bins[j] = V(0);
  }
}

// ---------------------------------------------------------------------------------------------
// the counting kernel

// kSmem: the block keeps the sorted grid, its bucket table (m buckets) and its histogram in
// shared memory and merges the histogram across its cluster. Otherwise (grids too large for
// shared memory) it searches `sorted` in global memory and adds straight into `acc`.
// acc: Weights<W>::kSlots * (t + 1) zeroed accumulators; ticket: a zeroed counter. Both are
// zero again when the kernel ends. out: 2 * t floats, tp then fp, every one written.
template <typename W, bool kSmem>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
count_kernel(const float* __restrict__ preds, const W* __restrict__ pos, const W* __restrict__ neg, long long n,
             const float* __restrict__ sorted, const int* __restrict__ perm, int t, int m,
             typename Weights<W>::Acc* __restrict__ acc, unsigned int* __restrict__ ticket,
             float* __restrict__ out) {
  using WT = Weights<W>;
  using Acc = typename WT::Acc;
  using Vec = typename WT::Vec;
  const int nb = t + 1;

  // the samples: a scalar head up to the first 16-byte aligned score, float4 vectors, a scalar tail
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(preds);
  long long head = static_cast<long long>(((16u - (pa & 15u)) & 15u) / 4u);
  if (head > n) head = n;
  const bool vec = (pa & 3u) == 0 && (reinterpret_cast<uintptr_t>(pos + head) % WT::kVecAlign) == 0 &&
                   (reinterpret_cast<uintptr_t>(neg + head) % WT::kVecAlign) == 0;
  if (!vec) head = n;  // weights that do not line up with the scores: every sample scalar
  const long long nvec = (n - head) / 4;
  const float4* p4 = reinterpret_cast<const float4*>(preds + head);
  const W* pos4 = pos + head;
  const W* neg4 = neg + head;

  Grid g{sorted, nullptr, t, m, 0.f, 0.f};
  Acc* h = acc;
  float* s = nullptr;
  int* tab = nullptr;
  __shared__ float sh_lo, sh_hi;
  __shared__ int sh_tf;
  if constexpr (kSmem) {
    // stage the grid, and find the finite range [lo, hi] and the count tf of thresholds that are
    // not NaN (one writer each; the grid is sorted, NaN last)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    h = reinterpret_cast<Acc*>(smem_raw);
    s = reinterpret_cast<float*>(h + WT::kSlots * nb);
    tab = reinterpret_cast<int*>(s + t);
    if (threadIdx.x == 0) {
      sh_lo = sh_hi = 0.f;
      sh_tf = 0;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < t; k += kThreads) {
      const float x = sorted[k];
      const float before = k > 0 ? sorted[k - 1] : -INFINITY;
      const float after = k + 1 < t ? sorted[k + 1] : NAN;
      s[k] = x;
      if (!isnan(x) && isnan(after)) sh_tf = k + 1;
      if (isfinite(x) && !isfinite(before)) sh_lo = x;
      if (isfinite(x) && !isfinite(after)) sh_hi = x;
    }
    for (int k = threadIdx.x; k < WT::kSlots * nb; k += kThreads) h[k] = Acc(0);
    // the last block reads perm at the end: ask for it in L2 now (one 128-byte line a block)
    if (threadIdx.x == 0 && static_cast<long long>(blockIdx.x) * 32 < t)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(perm + blockIdx.x * 32));
  }

  // the first pair of vectors is requested before the block builds its table, so its latency
  // overlaps it; from then on a pair is in flight while the previous pair is bucketed
  long long v = gtid;
  float4 p_cur[2] = {};
  Vec wp_cur[2] = {}, wn_cur[2] = {};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long j = v + u * nthreads;
    if (j < nvec) {
      p_cur[u] = __ldcs(p4 + j);
      wp_cur[u] = WT::load4(pos4 + 4 * j);
      wn_cur[u] = WT::load4(neg4 + 4 * j);
    }
  }

  if constexpr (kSmem) {
    __syncthreads();
    g.lo = sh_lo;
    const float span = __fsub_rn(sh_hi, sh_lo);
    float inv_w = span > 0.f ? __fdiv_rn(static_cast<float>(m), span) : 0.f;
    if (!(inv_w < INFINITY)) inv_w = 0.f;
    g.inv_w = inv_w;
    // tab[b + 1] = #{k < tf : bucket(s[k]) <= b}; bucket() is non-decreasing along s[0..tf),
    // so threshold k owns the buckets from bucket(s[k - 1]) up to bucket(s[k]) - 1
    const int tf = sh_tf;
    if (threadIdx.x == 0) tab[0] = 0;
    for (int k = threadIdx.x; k <= tf; k += kThreads) {
      const int b_hi = k < tf ? bucket(s[k], g.lo, inv_w, m) : m;
      const int b_lo = k > 0 ? bucket(s[k - 1], g.lo, inv_w, m) : 0;
      for (int b = b_lo; b < b_hi; ++b) tab[b + 1] = k;
    }
    __syncthreads();
    g.s = s;
    g.tab = tab;
  }

  for (long long i = gtid; i < head; i += nthreads)
    WT::add(h, nb, find_bin<kSmem>(g, preds[i]), WT::load1(pos + i), WT::load1(neg + i));
  for (long long i = head + 4 * nvec + gtid; i < n; i += nthreads)
    WT::add(h, nb, find_bin<kSmem>(g, preds[i]), WT::load1(pos + i), WT::load1(neg + i));
  // the float4 body, two vectors a step
  while (v < nvec) {
    float4 p_nxt[2] = {};
    Vec wp_nxt[2] = {}, wn_nxt[2] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long j = v + (2 + u) * nthreads;
      if (j < nvec) {
        p_nxt[u] = __ldcs(p4 + j);
        wp_nxt[u] = WT::load4(pos4 + 4 * j);
        wn_nxt[u] = WT::load4(neg4 + 4 * j);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (v + u * nthreads < nvec) count4<WT, kSmem>(g, h, nb, p_cur[u], wp_cur[u], wn_cur[u]);
      p_cur[u] = p_nxt[u];
      wp_cur[u] = wp_nxt[u];
      wn_cur[u] = wn_nxt[u];
    }
    v += 2 * nthreads;
  }

  if constexpr (kSmem) {
    // sum the cluster's histograms: block r of the cluster owns slots [r * per, (r + 1) * per)
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int slots = WT::kSlots * nb;
    const int per = (slots + kCluster - 1) / kCluster;
    const int begin = static_cast<int>(cluster.block_rank()) * per;
    const int end = min(slots, begin + per);
    for (int k0 = begin + threadIdx.x; k0 < end; k0 += 2 * kThreads) {
      Acc part[2][kCluster];  // 2 slots x kCluster blocks: the remote loads are in flight together
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          part[j][q] = k0 + j * kThreads < end ? cluster.map_shared_rank(h, q)[k0 + j * kThreads] : Acc(0);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Acc sum = part[j][0];
#pragma unroll
        for (int q = 1; q < kCluster; ++q) sum += part[j][q];
        if (sum != Acc(0)) atomicAdd(acc + k0 + j * kThreads, sum);
      }
    }
    cluster.sync();  // no block leaves while another still reads its shared memory
  }

  // the last block to arrive finishes the call
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if constexpr (kSmem) {
    // stage the accumulators and perm in shared memory with asynchronous copies, all in flight at
    // once, so the scan waits on one round trip to L2; then zero the accumulators for the next call.
    // The accumulators come from L2 alone (16-byte .cg copies, the last bytes with ld.global.cg):
    // other SMs' atomics wrote them, and no L1 line of this SM may serve them. Each thread zeroes
    // only what it copied itself, once its own copies have landed.
    int* sperm = reinterpret_cast<int*>(s);
    const int slots = WT::kSlots * nb;
    const int chunks = static_cast<int>(slots * sizeof(Acc) / 16);
    const int tail = chunks * 16 / static_cast<int>(sizeof(Acc));
    uint4* acc16 = reinterpret_cast<uint4*>(acc);
    for (int k = threadIdx.x; k < chunks; k += kThreads) copy_async_l2(reinterpret_cast<uint4*>(h) + k, acc16 + k);
    for (int k = threadIdx.x; k < t; k += kThreads) copy_async(sperm + k, perm + k);
    for (int k = tail + threadIdx.x; k < slots; k += kThreads) {
      h[k] = __ldcg(acc + k);
      acc[k] = Acc(0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int k = threadIdx.x; k < chunks; k += kThreads) acc16[k] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    finish<false>(h, t, sperm, out);
  } else {
    finish<true>(acc, t, perm, out);
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ---------------------------------------------------------------------------------------------
// launch plans, cached per device, weight kind and grid size

struct Plan {
  int device = -1, kind = -1, t = -1;
  bool smem_route = false;
  int m = 0;
  size_t smem = 0;
  int resident_blocks = 0;  // blocks of this kernel the card holds at once
};

std::mutex g_plans_mu;
Plan g_plans[32];
int g_nplans = 0;
bool g_smem_attr_set[64][2];  // per device and weight kind: max dynamic shared memory raised

template <typename W>
size_t smem_bytes(int t, int m) {
  return static_cast<size_t>(Weights<W>::kSlots) * (t + 1) * sizeof(typename Weights<W>::Acc) +
         static_cast<size_t>(t) * sizeof(float) + static_cast<size_t>(m + 1) * sizeof(int);
}

template <typename W>
cudaError_t make_plan(int device, int kind, int t, Plan* out) {
  Plan p;
  p.device = device;
  p.kind = kind;
  p.t = t;
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, count_kernel<W, true>)) != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(optin) - fa.sharedSizeBytes;  // dynamic, beside the static
  // a bucket table of 2T entries where it fits; else one bucket (a plain binary search); else global
  p.m = 2 * t;
  if (smem_bytes<W>(t, p.m) > budget) p.m = 1;
  p.smem_route = smem_bytes<W>(t, p.m) <= budget;
  if (p.smem_route) {
    p.smem = smem_bytes<W>(t, p.m);
    if (device >= 64 || !g_smem_attr_set[device][kind]) {
      err = cudaFuncSetAttribute(count_kernel<W, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(budget));
      if (err != cudaSuccess) return err;
      if (device < 64) g_smem_attr_set[device][kind] = true;
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * sms, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, count_kernel<W, true>, &cfg)) != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    p.resident_blocks = clusters * kCluster;
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel<W, false>, kThreads, 0);
    if (err != cudaSuccess) return err;
    p.resident_blocks = sms * (per_sm < 1 ? 1 : per_sm);
  }
  *out = p;
  return cudaSuccess;
}

template <typename W>
cudaError_t get_plan(int device, int kind, int t, Plan* out) {
  std::lock_guard<std::mutex> lock(g_plans_mu);
  for (int i = 0; i < g_nplans; ++i) {
    if (g_plans[i].device == device && g_plans[i].kind == kind && g_plans[i].t == t) {
      *out = g_plans[i];
      return cudaSuccess;
    }
  }
  cudaError_t err = make_plan<W>(device, kind, t, out);
  if (err != cudaSuccess) return err;
  g_plans[g_nplans < 32 ? g_nplans++ : 31] = *out;  // a full cache keeps replacing its last entry
  return cudaSuccess;
}

template <typename W>
cudaError_t launch(const float* preds, const void* pos, const void* neg, long long n, const float* sorted,
                   const int* perm, int t, int kind, void* workspace, float* out, int device, cudaStream_t stream) {
  using Acc = typename Weights<W>::Acc;
  Plan p;
  cudaError_t err = get_plan<W>(device, kind, t, &p);
  if (err != cudaSuccess) return err;
  Acc* acc = static_cast<Acc*>(workspace);
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(static_cast<char*>(workspace) + Weights<W>::kSlots * (t + 1) * sizeof(Acc));
  // enough blocks that each thread has a full unrolled step of work, at most what the card holds
  const long long per_block = static_cast<long long>(kThreads) * 4 * 2;  // a pair of float4 a thread
  long long blocks = (n + per_block - 1) / per_block;
  if (p.smem_route) blocks = (blocks + kCluster - 1) / kCluster * kCluster;
  if (blocks > p.resident_blocks) blocks = p.resident_blocks;
  if (blocks < 1) blocks = 1;

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.smem_route ? kCluster : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = p.smem_route ? 1 : 0;
  const W* pw = static_cast<const W*>(pos);
  const W* nw = static_cast<const W*>(neg);
  if (p.smem_route)
    err = cudaLaunchKernelEx(&cfg, count_kernel<W, true>, preds, pw, nw, n, sorted, perm, t, p.m, acc, ticket, out);
  else
    err = cudaLaunchKernelEx(&cfg, count_kernel<W, false>, preds, pw, nw, n, sorted, perm, t, p.m, acc, ticket, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for a grid of t thresholds on `device`: out[0] 1 for the shared-memory route,
// out[1] buckets in the table, out[2] dynamic shared memory per block, out[3] resident blocks.
int mtt_binned_counts_plan(int t, int weight_kind, int device, long long* out) {
  Plan p;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = weight_kind == 0 ? get_plan<uint8_t>(device, 0, t, &p) : get_plan<float>(device, 1, t, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.smem_route ? 1 : 0;
  out[1] = p.m;
  out[2] = static_cast<long long>(p.smem);
  out[3] = p.resident_blocks;
  return 0;
}

// weight_kind 0: pos/neg are 0/1 bytes (torch.bool), n < 2^32. weight_kind 1: pos/neg are float32.
// sorted (t float32, ascending, NaN last) and perm (t int32, sorted[k] == thr[perm[k]]) are the
// ranked grid thr. workspace: 16-byte aligned, (weight_kind + 1) * (t + 1) * 8 bytes of
// accumulators, then a 16-byte ticket, zeroed by the caller once; every launch leaves it zeroed,
// and one workspace serves one stream at a time. out: 2 * t float32, tp then fp, indexed like thr.
// Requires n > 0 and t > 0.
int mtt_binned_counts(const float* preds, const void* pos, const void* neg, long long n, const float* sorted,
                      const int* perm, int t, int weight_kind, void* workspace, float* out, int device,
                      void* stream) {
  int previous = -1;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight_kind == 0)
    err = launch<uint8_t>(preds, pos, neg, n, sorted, perm, t, 0, workspace, out, device, s);
  else if (weight_kind == 1)
    err = launch<float>(preds, pos, neg, n, sorted, perm, t, 1, workspace, out, device, s);
  else
    err = cudaErrorInvalidValue;
  if (previous != device) {
    const cudaError_t restore = cudaSetDevice(previous);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

}  // extern "C"
