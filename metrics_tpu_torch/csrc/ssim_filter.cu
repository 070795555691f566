// The SSIM family's separable gaussian filter and its per-pixel map, hand-written for Hopper (sm_90a).
//
// For one NCHW float32 batch (preds p, target t) and a kh x kw window with taps g_h, g_w, every output pixel
// (y, x) of the valid extent (H - kh + 1) x (W - kw + 1) gets the five windowed moments
//
//   m[q](y, x) = sum_j g_w[j] * sum_i g_h[i] * f_q(y + i, x + j),   f = (p, t, p*p, t*t, p*t)
//
// and from them SSIM's (ssim_idx, cs_idx) or UQI's centred quality index. The plain version
// (functional/regression/ssim.py: a reflect pad, a stacked 5-map tensor, one shifted multiply-add pass a tap
// along H and then along W, a crop, ~15 pointwise ops) reflects at the border and then crops exactly the ring
// the reflection reached, so every kept pixel's window lies inside the image: this kernel reads only
// in-range pixels and never pads.
//
// It replaces no Pallas kernel: the JAX package's SSIM is an XLA convolution
// (metrics_tpu/functional/regression/ssim.py:_depthwise_conv_separable, Precision.HIGHEST).
//
// What bounds it on the H100: float32 arithmetic outside the tensor cores. A pixel costs 5 maps x (kh + kw)
// multiply-adds (110 at 11 x 11) against 8 bytes read, far above the card's ~20 FLOP a byte. The filter may
// not use TF32: var = E[x^2] - mu^2 cancels. So the design keeps the moments out of device memory and feeds
// the FMA units from registers:
//   * One block of 256 threads computes a 32 x 32 output tile of one (image, channel) plane. It stages the
//     tile's p and t with the (kh - 1, kw - 1) halo in shared memory (UQI subtracts its shift as it loads).
//   * Pass 1, along H: a thread forms the five moments of each staged pixel on the fly (3 products) and
//     slides them through 4 output rows of one column held in registers; the rows go to shared memory.
//   * Pass 2, along W: a thread slides the pass-1 rows through 4 output columns of one row in registers.
//     The rows' stride is 1 mod 4, so the warp's 4 rows x 8 threads hit 32 banks.
//   * The taps are runtime values in shared memory, read by a warp-uniform index; each output sums its taps
//     in order, from -0.0 (so the first product is exact, sign included), with fmaf: the plain version's
//     order, passes and roundings (a product, then a + w * b fused, as PyTorch's CUDA add with alpha), and
//     the epilogue rounds each operation as the plain version's separate ops do (__fmul_rn and friends keep
//     nvcc from contracting them).
//   * Output: the maps, or, on the hot path, each block's sums of its maps (a warp-shuffle tree and a fixed
//     order across warps: no atomics, so two runs are bit-equal) into a [maps][blocks] buffer that the caller
//     reduces per image or in total.
//
// The C entry launches on the caller's stream, never synchronises, allocates nothing, sets the kernels'
// shared-memory limit once per device, and returns the first CUDA error code that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;  // pass 1: output rows of one column a thread
constexpr int kColsPerThread = 4;  // pass 2: output columns of one row a thread
constexpr int kMaxSide = 31;       // longest window side
constexpr int kMoments = 5;
constexpr int kMaxDevices = 64;
static_assert(kTileH / kRowsPerThread * 32 == kThreads, "pass 1 maps a warp to 32 columns of one row group");
static_assert(kTileH * (kTileW / kColsPerThread) == kThreads, "pass 2 gives every thread one run of columns");

constexpr float kTiny = 1e-30f;       // uqi.py's _TINY
constexpr float kFlatScale = 0x1p-17f;  // 64 * float32 eps, uqi.py's flat test

struct Params {
  const float* preds;
  const float* target;
  const float* data_range;  // SSIM: null (c1, c2 given) or one device float the constants come from
  const float* shift;       // UQI: one device float both images are centred on
  float* out;
  long long planes;  // N * C
  int h, w, oh, ow, kh, kw;
  int tiles_w, tiles;  // tiles a row of tiles, tiles a plane
  int rows_in, cols_in, stride_v;
  float c1, c2, k1, k2;
  float taps_h[kMaxSide];
  float taps_w[kMaxSide];
};

inline int one_mod_four(int n) { return n + ((5 - (n & 3)) & 3); }

inline size_t smem_bytes(int kh, int kw) {
  const int rows_in = kTileH + kh - 1, cols_in = kTileW + kw - 1;
  return sizeof(float) *
         (2 * kMaxSide + 2 * rows_in * cols_in + kMoments * kTileH * static_cast<size_t>(one_mod_four(cols_in)));
}

// the per-pixel values from the five filtered moments: SSIM (ssim_idx, cs_idx) or UQI (q, unused)
template <bool kUqi>
__device__ __forceinline__ void pixel(const float (&a)[kMoments], float c1, float c2, float shift, float& v0,
                                      float& v1) {
  const float mp = a[0], mt = a[1];
  const float mp2 = __fmul_rn(mp, mp), mt2 = __fmul_rn(mt, mt);
  const float vp = __fsub_rn(a[2], mp2), vt = __fsub_rn(a[3], mt2), cov = __fsub_rn(a[4], __fmul_rn(mp, mt));
  if (!kUqi) {
    // ssim.py _ssim_map: cs = (2 cov + c2) / (var_p + var_t + c2),
    // ssim = ((2 mu_p mu_t + c1) / (mu_p^2 + mu_t^2 + c1)) cs
    const float cs = __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, cov), c2), __fadd_rn(__fadd_rn(vp, vt), c2));
    const float lum =
        __fdiv_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.0f, mp), mt), c1), __fadd_rn(__fadd_rn(mp2, mt2), c1));
    v0 = __fmul_rn(lum, cs);
    v1 = cs;
  } else {
    // uqi.py: mp, mt above are the centred means mu_pc, mu_tc
    const float up = __fadd_rn(mp, shift), ut = __fadd_rn(mt, shift);
    const float denom_v = __fadd_rn(vp, vt);
    const float denom_m = __fadd_rn(__fmul_rn(up, up), __fmul_rn(ut, ut));
    const float second_c = __fadd_rn(__fadd_rn(__fadd_rn(vp, mp2), vt), mt2);
    const bool flat = denom_v <= __fadd_rn(__fmul_rn(kFlatScale, second_c), kTiny);
    const float dv = denom_v < kTiny ? kTiny : denom_v;  // clamp_min keeps a NaN
    const float dm = denom_m < kTiny ? kTiny : denom_m;
    const float contrast = flat ? 1.0f : __fdiv_rn(__fmul_rn(2.0f, cov), dv);
    const float luminance = denom_m <= kTiny ? 1.0f : __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, up), ut), dm);
    v0 = __fmul_rn(contrast, luminance);
    v1 = 0.0f;
  }
}

template <bool kUqi, bool kMaps>
__global__ void __launch_bounds__(kThreads, 4) ssim_filter_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  float* s_th = smem;
  float* s_tw = smem + kMaxSide;
  float* s_p = smem + 2 * kMaxSide;           // rows_in x cols_in
  float* s_t = s_p + p.rows_in * p.cols_in;   // rows_in x cols_in
  float* s_v = s_t + p.rows_in * p.cols_in;   // kMoments x kTileH x stride_v: pass 1's rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long block = blockIdx.x;
  const long long plane = block / p.tiles;
  const int tile = static_cast<int>(block - plane * p.tiles);
  const int y0 = tile / p.tiles_w * kTileH;
  const int x0 = tile % p.tiles_w * kTileW;
  const long long base = plane * p.h * static_cast<long long>(p.w);

  if (tid < p.kh) s_th[tid] = p.taps_h[tid];
  if (tid < p.kw) s_tw[tid] = p.taps_w[tid];
  const float shift = kUqi ? *p.shift : 0.0f;

  // stage the tile and its halo; pixels past the image feed only outputs past the valid extent
  for (int y = warp; y < p.rows_in; y += kWarps) {
    const int gy = y0 + y;
    for (int x = lane; x < p.cols_in; x += 32) {
      const int gx = x0 + x;
      float a = 0.0f, b = 0.0f;
      if (gy < p.h && gx < p.w) {
        const long long off = base + static_cast<long long>(gy) * p.w + gx;
        a = __ldg(p.preds + off);
        b = __ldg(p.target + off);
        if (kUqi) {
          a = __fsub_rn(a, shift);
          b = __fsub_rn(b, shift);
        }
      }
      s_p[y * p.cols_in + x] = a;
      s_t[y * p.cols_in + x] = b;
    }
  }
  __syncthreads();

  // pass 1, along H: 4 output rows of one staged column a thread
  constexpr int kGroups = kTileH / kRowsPerThread;
  for (int i = tid; i < kGroups * p.cols_in; i += kThreads) {
    const int g = i / p.cols_in, x = i - g * p.cols_in, r0 = g * kRowsPerThread;
    float acc[kRowsPerThread][kMoments];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int m = 0; m < kMoments; ++m) acc[r][m] = -0.0f;
    const int span = kRowsPerThread + p.kh - 1;
    for (int y = 0; y < span; ++y) {
      const float a = s_p[(r0 + y) * p.cols_in + x], b = s_t[(r0 + y) * p.cols_in + x];
      const float v[kMoments] = {a, b, __fmul_rn(a, a), __fmul_rn(b, b), __fmul_rn(a, b)};
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int k = y - r;  // the same for the whole warp
        if (k >= 0 && k < p.kh) {
          const float wk = s_th[k];
#pragma unroll
          for (int m = 0; m < kMoments; ++m) acc[r][m] = fmaf(wk, v[m], acc[r][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int m = 0; m < kMoments; ++m) s_v[(m * kTileH + r0 + r) * p.stride_v + x] = acc[r][m];
  }
  __syncthreads();

  // pass 2, along W: 4 output columns of one row a thread, then the per-pixel values
  const int row = tid / (kTileW / kColsPerThread);
  const int c0 = tid % (kTileW / kColsPerThread) * kColsPerThread;
  float acc[kColsPerThread][kMoments];
#pragma unroll
  for (int r = 0; r < kColsPerThread; ++r)
#pragma unroll
    for (int m = 0; m < kMoments; ++m) acc[r][m] = -0.0f;
  const int span = kColsPerThread + p.kw - 1;
  for (int x = 0; x < span; ++x) {
    float v[kMoments];
#pragma unroll
    for (int m = 0; m < kMoments; ++m) v[m] = s_v[(m * kTileH + row) * p.stride_v + c0 + x];
#pragma unroll
    for (int r = 0; r < kColsPerThread; ++r) {
      const int k = x - r;
      if (k >= 0 && k < p.kw) {
        const float wk = s_tw[k];
#pragma unroll
        for (int m = 0; m < kMoments; ++m) acc[r][m] = fmaf(wk, v[m], acc[r][m]);
      }
    }
  }

  float c1 = p.c1, c2 = p.c2;
  if (!kUqi && p.data_range != nullptr) {  // ssim.py: c = (k * data_range) ** 2 on the card
    const float dr = *p.data_range;
    const float a1 = __fmul_rn(p.k1, dr), a2 = __fmul_rn(p.k2, dr);
    c1 = __fmul_rn(a1, a1);
    c2 = __fmul_rn(a2, a2);
  }
  constexpr int kOut = kUqi ? 1 : 2;
  const int gy = y0 + row;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int r = 0; r < kColsPerThread; ++r) {
    const int gx = x0 + c0 + r;
    if (gy < p.oh && gx < p.ow) {
      float v0, v1;
      pixel<kUqi>(acc[r], c1, c2, shift, v0, v1);
      if (kMaps) {
        const long long map = p.planes * p.oh * static_cast<long long>(p.ow);
        const long long at = plane * p.oh * static_cast<long long>(p.ow) + static_cast<long long>(gy) * p.ow + gx;
        p.out[at] = v0;
        if (kOut == 2) p.out[map + at] = v1;
      } else {
        sum0 += v0;
        sum1 += v1;
      }
    }
  }
  if (kMaps) return;

  // the block's sums in a fixed order: a shuffle tree a warp, then the warps in turn
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sum0 += __shfl_down_sync(0xffffffffu, sum0, d);
    sum1 += __shfl_down_sync(0xffffffffu, sum1, d);
  }
  float* s_sum = s_p;  // pass 1 is done with the staged tile
  if (lane == 0) {
    s_sum[warp] = sum0;
    s_sum[kWarps + warp] = sum1;
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = s_sum[0], t1 = s_sum[kWarps];
    for (int i = 1; i < kWarps; ++i) {
      t0 += s_sum[i];
      t1 += s_sum[kWarps + i];
    }
    const long long blocks = p.planes * p.tiles;
    p.out[block] = t0;
    if (kOut == 2) p.out[blocks + block] = t1;
  }
}

std::mutex g_mutex;
bool g_ready[kMaxDevices];

// the largest window's shared memory, allowed once per device for each instance
cudaError_t prepare(int device) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_ready[device]) return cudaSuccess;
  const int bytes = static_cast<int>(smem_bytes(kMaxSide, kMaxSide));
  cudaError_t err = cudaFuncSetAttribute(ssim_filter_kernel<false, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssim_filter_kernel<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssim_filter_kernel<true, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssim_filter_kernel<true, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) g_ready[device] = true;
  return err;
}

bool odd_side(int k) { return k >= 1 && k <= kMaxSide && (k & 1) == 1; }

}  // namespace

extern "C" {

// preds, target: planes x h x w float32, contiguous, on `device`. taps: host floats, kh along H then kw along W
// (odd, at most 31 each; h >= kh, w >= kw). uqi 0: SSIM, with c1 and c2, or (data_range non-null) c = (k * dr)^2
// from one device float; uqi 1: UQI, shift one device float. maps 1: out holds the maps, [M][planes][oh][ow];
// maps 0: each block's sums, [M][planes * tiles]; M = 2 (ssim, cs) for SSIM, 1 for UQI. out_elems must equal
// that size. Launches on `stream` and returns the first CUDA error, or cudaErrorInvalidValue for bad arguments.
int mtt_ssim_filter(const float* preds, const float* target, long long planes, int h, int w, int kh, int kw,
                    const float* taps, int uqi, int maps, float c1, float c2, float k1, float k2,
                    const float* data_range, const float* shift, float* out, long long out_elems, int device,
                    void* stream) {
  if (planes <= 0 || !odd_side(kh) || !odd_side(kw) || h < kh || w < kw || (uqi && shift == nullptr) ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.preds = preds;
  p.target = target;
  p.data_range = uqi ? nullptr : data_range;
  p.shift = uqi ? shift : nullptr;
  p.out = out;
  p.planes = planes;
  p.h = h;
  p.w = w;
  p.oh = h - kh + 1;
  p.ow = w - kw + 1;
  p.kh = kh;
  p.kw = kw;
  p.tiles_w = (p.ow + kTileW - 1) / kTileW;
  p.tiles = p.tiles_w * ((p.oh + kTileH - 1) / kTileH);
  p.rows_in = kTileH + kh - 1;
  p.cols_in = kTileW + kw - 1;
  p.stride_v = one_mod_four(p.cols_in);
  p.c1 = c1;
  p.c2 = c2;
  p.k1 = k1;
  p.k2 = k2;
  for (int i = 0; i < kh; ++i) p.taps_h[i] = taps[i];
  for (int i = 0; i < kw; ++i) p.taps_w[i] = taps[kh + i];
  const long long blocks = planes * p.tiles;
  const long long m = uqi ? 1 : 2;
  const long long want = maps ? m * planes * p.oh * static_cast<long long>(p.ow) : m * blocks;
  if (blocks > 0x7fffffffLL || out_elems != want) return static_cast<int>(cudaErrorInvalidValue);

  int previous = -1;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  err = prepare(device);
  if (err == cudaSuccess) {
    const dim3 grid(static_cast<unsigned int>(blocks));
    const size_t smem = smem_bytes(kh, kw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (uqi && maps)
      ssim_filter_kernel<true, true><<<grid, kThreads, smem, s>>>(p);
    else if (uqi)
      ssim_filter_kernel<true, false><<<grid, kThreads, smem, s>>>(p);
    else if (maps)
      ssim_filter_kernel<false, true><<<grid, kThreads, smem, s>>>(p);
    else
      ssim_filter_kernel<false, false><<<grid, kThreads, smem, s>>>(p);
    err = cudaGetLastError();
  }
  if (previous != device) {
    const cudaError_t restore = cudaSetDevice(previous);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

}  // extern "C"
