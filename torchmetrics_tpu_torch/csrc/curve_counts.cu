// K3: per-threshold counts of the binned curve family, for Hopper (sm_90a).
//
// Replaces torchmetrics_tpu/ops/pallas_curve.py::_curve_counts_kernel (entry curve_counts_pallas)
// and the class-batched dot of precision_recall_curve.py::_indicator_counts. Two entries:
//
// tm_binned_confmat: the binned metric path, one launch per call. The weights there are always
// the 0/1 ignore mask and the thresholds always sorted, so the count is a histogram:
//
//   - bucketize: each (sample, class) element finds k = #{t : score >= thr[t]} by a binary search
//     over the thresholds staged in shared memory, with the same `>=` as the JAX kernel. For
//     thresholds sorted ascending that is exactly the number of thresholds the direct compare
//     meets, for ties, duplicates, +-inf and +-0. A NaN score meets none: bucket 0.
//   - the loaders form the inputs in registers: binary (N,) scores and an int or bool target;
//     multiclass (N, C) scores read in place with an (N,) class index (positive for class c when
//     target == c); multilabel (N, C) scores and an (N, C) 0/1 target. An element whose target
//     equals ignore_index is dropped (the whole sample for binary and multiclass).
//   - each block keeps int32 (T+1) x {neg, pos} histograms per class of its class group in
//     shared memory (8 KB at C = 5, T = 200); class groups go over blockIdx.y. Above 47 KB for
//     one class (T > 4000) the histograms live in global scratch instead.
//   - across blocks: each block adds its non-zero bins into int32 sums in global scratch and
//     takes a ticket after a __threadfence(); the last block of a class group reads the sums back
//     into shared memory in one coalesced pass (a scan straight from L2 would wait on one load
//     latency per 32 buckets) and scans them:
//     tp[t] and fp[t] are suffix sums of the histograms past bucket t, fn[t] and tn[t] prefix
//     sums up to it. It writes the (T, C, 2, 2) float32 output [t, c, target, pred] in full and
//     sets the sums and its ticket back to 0 for the next call and for a CUDA-graph replay. The
//     wrapper keeps that scratch per device and stream (ops/bincount.py::zeroed_scratch).
//
//   The work is O(N log T + T) per class, against O(N T) for the direct compare. Integer adds
//   make the counts exact and independent of order; as float32 they are exact below 2^24, the
//   JAX package's contract. A NaN counts in no tp or fp but in the totals behind tn and fn, as
//   there (sum(neg) - fp). Bound: the bytes it must read, 4 B of score and 1-8 B of target per
//   element, or its operations (about log2(T) + 4 per element), whichever is larger.
//
// tm_curve_counts: general pos/neg float weights and thresholds in any order, the direct compare.
// For each class row c of scores, pos and neg (C, N) and each threshold t:
//
//   tp[c, t] = sum_i pos[c, i] * [scores[c, i] >= thr[t]]
//   fp[c, t] = sum_i neg[c, i] * [scores[c, i] >= thr[t]]
//
// The compare is direct, so the thresholds need not be sorted, and a NaN score meets no
// threshold and counts nowhere, as in the JAX package. Nothing (N, T)-shaped is ever stored.
//
// Design. The TPU kernel keeps a (2, T) accumulator resident across a sequential grid over
// sample tiles. Here blocks run in parallel and in no order, so:
//
//   - a block owns one class row, up to 2048 thresholds (threshold chunk) and one contiguous
//     chunk of samples. Each thread holds PER_THREAD thresholds and their two sums in registers;
//   - the block stages 512 samples at a time in shared memory as (score, pos, neg) float4s, and
//     every thread walks the tile in the same order: each read is a broadcast, free of bank
//     conflicts, and feeds PER_THREAD compares and 2 * PER_THREAD adds;
//   - each block writes its sums to a (blocks, 2, C, T) scratch, and a second kernel adds the
//     scratch over blocks in a fixed order (a fixed split over 32 lanes, then a fixed tree).
//     There are no float atomics, so the result is bitwise repeatable for any weights. With one
//     sample block the first kernel writes the output itself.
//
// Bound on the card: operations. The work is 3 * C * N * T compares and adds against
// 12 * C * N bytes read; at C = 1, N = 1M, T = 200 that is 6e8 operations, 9 us at the float32
// rate outside the tensor cores, and 3.6 us of HBM reads. What holds the kernel below that bound:
// one shared-memory read per sample for every PER_THREAD thresholds (PER_THREAD is 2 at T = 200),
// and the idle lanes of the last warp when T is not a multiple of 32.
//
// Counts are float32: exact for 0/1 weights while a sum stays below 2^24, as in the JAX package.
//
// Plain C interface, loaded with ctypes: each entry returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include <math.h>

#include "device_cache.cuh"

namespace {

constexpr int kTile = 512;
constexpr int kReduceLanes = 32;

template <int PER_THREAD>
__global__ void __launch_bounds__(256) counts_partial(
    const float* __restrict__ scores, const float* __restrict__ pos, const float* __restrict__ neg,
    const float* __restrict__ thr, long long n, int num_classes, int num_thr, int chunks_t,
    long long chunk, float* __restrict__ partial) {
  __shared__ float4 tile[kTile];
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  const int span = blockDim.x * PER_THREAD;
  const long long plane = static_cast<long long>(num_classes) * num_thr;  // one (C, T) block of the scratch
  for (int row = blockIdx.y; row < num_classes * chunks_t; row += gridDim.y) {
    const int c = row / chunks_t;
    const int t0 = (row % chunks_t) * span;
    float my_thr[PER_THREAD];
    float tp[PER_THREAD];
    float fp[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int t = t0 + threadIdx.x + k * blockDim.x;
      my_thr[k] = t < num_thr ? thr[t] : INFINITY;
      tp[k] = 0.f;
      fp[k] = 0.f;
    }
    const float* s_row = scores + static_cast<long long>(c) * n;
    const float* p_row = pos + static_cast<long long>(c) * n;
    const float* n_row = neg + static_cast<long long>(c) * n;
    for (long long base = begin; base < end; base += kTile) {
      const int m = static_cast<int>(end - base < kTile ? end - base : kTile);
      __syncthreads();  // every thread is done with the previous tile
      for (int j = threadIdx.x; j < m; j += blockDim.x) {
        tile[j] = make_float4(s_row[base + j], p_row[base + j], n_row[base + j], 0.f);
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float4 v = tile[j];
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
          const bool hit = v.x >= my_thr[k];
          tp[k] += hit ? v.y : 0.f;
          fp[k] += hit ? v.z : 0.f;
        }
      }
    }
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * plane + static_cast<long long>(c) * num_thr;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int t = t0 + threadIdx.x + k * blockDim.x;
      if (t < num_thr) {
        out[t] = tp[k];
        out[plane + t] = fp[k];
      }
    }
  }
}

// out[r] = sum over b of partial[b * rows + r], for r in [0, rows). A block of 32 x 32 threads
// covers 32 outputs: lane y sums b = y, y + 32, ... in order, then the 32 lane sums are added
// by a fixed tree. The order of the adds depends only on `blocks`, never on the schedule.
__global__ void __launch_bounds__(kReduceLanes * kReduceLanes) counts_reduce(
    const float* __restrict__ partial, int blocks, long long rows, float* __restrict__ out) {
  __shared__ float sums[kReduceLanes][kReduceLanes + 1];
  const long long r = static_cast<long long>(blockIdx.x) * kReduceLanes + threadIdx.x;
  float acc = 0.f;
  if (r < rows) {
    for (int b = threadIdx.y; b < blocks; b += kReduceLanes) acc += partial[static_cast<long long>(b) * rows + r];
  }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceLanes / 2; half > 0; half /= 2) {
    if (threadIdx.y < half) sums[threadIdx.y][threadIdx.x] += sums[threadIdx.y + half][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && r < rows) out[r] = sums[0][threadIdx.x];
}

template <int PER_THREAD>
void launch_partial(dim3 grid, int threads, cudaStream_t stream, const float* scores, const float* pos,
                    const float* neg, const float* thr, long long n, int num_classes, int num_thr,
                    int chunks_t, long long chunk, float* partial) {
  counts_partial<PER_THREAD><<<grid, threads, 0, stream>>>(scores, pos, neg, thr, n, num_classes, num_thr,
                                                           chunks_t, chunk, partial);
}


constexpr int kBinnedThreads = 512;
constexpr int kBinnedWarps = kBinnedThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kBinary = 0, kMulticlass = 1, kMultilabel = 2 };

__device__ __forceinline__ unsigned read_count(const unsigned* p, bool global) { return global ? __ldcg(p) : *p; }

// One (T+1)-bucket histogram `row` of class c and target `positive` -> the output's
// [t, c, positive, 0] (samples at or below bucket t: tn or fn) and [t, c, positive, 1] (above it:
// fp or tp) for every t, by one warp: a total, then a running inclusive scan in chunks of 32.
// With `clear`, the global sums are set back to 0 as they are read.
__device__ __forceinline__ void scan_row(unsigned* row, bool global, bool clear, int num_thr, int num_classes, int c,
                                         int positive, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int buckets = num_thr + 1;
  unsigned total = 0;
  for (int k = lane; k < buckets; k += 32) total += read_count(row + k, global);
  for (int off = 16; off > 0; off /= 2) total += __shfl_xor_sync(kFullMask, total, off);
  unsigned carry = 0;
  for (int k0 = 0; k0 < buckets; k0 += 32) {
    const int k = k0 + lane;
    unsigned v = k < buckets ? read_count(row + k, global) : 0u;
    if (clear && k < buckets) row[k] = 0u;
    for (int off = 1; off < 32; off *= 2) {
      const unsigned up = __shfl_up_sync(kFullMask, v, off);
      if (lane >= off) v += up;
    }
    const unsigned below = carry + v;  // elements of buckets 0..k: they meet threshold k nowhere
    if (k < num_thr) {
      float* o = out + ((static_cast<long long>(k) * num_classes + c) * 2 + positive) * 2;
      o[0] = static_cast<float>(below);
      o[1] = static_cast<float>(total - below);
    }
    carry += __shfl_sync(kFullMask, v, 31);
  }
}

template <typename TT, int KIND, bool SHARED>
__global__ void __launch_bounds__(kBinnedThreads) binned_confmat(
    const float* __restrict__ scores, const TT* __restrict__ target, const float* __restrict__ thr, long long n,
    int num_classes, int num_thr, int group, long long ignore_index, int has_ignore, int head,
    unsigned* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float staged[];  // SHARED: the thresholds, then the class group's histograms
  __shared__ int last;
  const int buckets = num_thr + 1;
  const int c0 = blockIdx.y * group;
  const int classes = min(group, num_classes - c0);
  const int words = classes * 2 * buckets;
  unsigned* sums = scratch + head + static_cast<long long>(c0) * 2 * buckets;
  const float* ts = thr;
  unsigned* hist = sums;
  if (SHARED) {
    for (int j = threadIdx.x; j < num_thr; j += blockDim.x) staged[j] = thr[j];
    hist = reinterpret_cast<unsigned*>(staged + num_thr);
    for (int w = threadIdx.x; w < words; w += blockDim.x) hist[w] = 0u;
    ts = staged;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    long long label = 0;
    if (KIND != kMultilabel) {
      label = static_cast<long long>(target[i]);
      if (has_ignore && label == ignore_index) continue;
    }
    for (int cj = 0; cj < classes; ++cj) {
      const long long e = KIND == kBinary ? i : i * num_classes + c0 + cj;
      int positive;
      if (KIND == kMultilabel) {
        const long long t = static_cast<long long>(target[e]);
        if (has_ignore && t == ignore_index) continue;
        positive = t != 0;
      } else {
        positive = KIND == kMulticlass ? label == c0 + cj : label != 0;
      }
      const float s = scores[e];
      int lo = 0;
      int hi = num_thr;
      while (lo < hi) {  // first threshold the score does not meet; a NaN meets none
        const int mid = (lo + hi) / 2;
        if (s >= ts[mid]) lo = mid + 1;
        else hi = mid;
      }
      atomicAdd(&hist[(cj * 2 + positive) * buckets + lo], 1u);
    }
  }
  const bool direct = SHARED && gridDim.x == 1;  // this block's histograms are the whole count
  if (SHARED) {
    __syncthreads();
    if (!direct) {
      for (int w = threadIdx.x; w < words; w += blockDim.x) {
        const unsigned v = hist[w];
        if (v != 0u) atomicAdd(&sums[w], v);
      }
    }
  }
  if (gridDim.x > 1) {
    __threadfence();  // this block's sums are visible before its ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&scratch[blockIdx.y], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  if (SHARED && !direct) {  // bring the sums into shared memory in one coalesced pass, clearing them
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      hist[w] = __ldcg(&sums[w]);
      sums[w] = 0u;
    }
    __syncthreads();
  }
  for (int a = threadIdx.x / 32; a < classes * 2; a += kBinnedWarps) {
    scan_row((SHARED ? hist : sums) + a * buckets, !SHARED, !SHARED, num_thr, num_classes, c0 + a / 2, a % 2, out);
  }
  if (gridDim.x > 1 && threadIdx.x == 0) scratch[blockIdx.y] = 0u;
}

template <typename TT, int KIND>
int launch_binned(const void* scores, const void* target, const void* thr, long long n, int num_classes, int num_thr,
                  int group, int groups, int blocks, int shared_bytes, int head, long long ignore_index,
                  int has_ignore, void* scratch, void* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  const float* sc = static_cast<const float*>(scores);
  const TT* tg = static_cast<const TT*>(target);
  const float* th = static_cast<const float*>(thr);
  unsigned* scr = static_cast<unsigned*>(scratch);
  float* o = static_cast<float*>(out);
  if (shared_bytes > 0) {
    binned_confmat<TT, KIND, true><<<grid, kBinnedThreads, shared_bytes, stream>>>(
        sc, tg, th, n, num_classes, num_thr, group, ignore_index, has_ignore, head, scr, o);
  } else {
    binned_confmat<TT, KIND, false><<<grid, kBinnedThreads, 0, stream>>>(
        sc, tg, th, n, num_classes, num_thr, group, ignore_index, has_ignore, head, scr, o);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TT>
int launch_binned_kind(int kind, const void* scores, const void* target, const void* thr, long long n,
                       int num_classes, int num_thr, int group, int groups, int blocks, int shared_bytes, int head,
                       long long ignore_index, int has_ignore, void* scratch, void* out, cudaStream_t stream) {
  switch (kind) {
    case kBinary:
      return launch_binned<TT, kBinary>(scores, target, thr, n, num_classes, num_thr, group, groups, blocks,
                                        shared_bytes, head, ignore_index, has_ignore, scratch, out, stream);
    case kMulticlass:
      return launch_binned<TT, kMulticlass>(scores, target, thr, n, num_classes, num_thr, group, groups, blocks,
                                            shared_bytes, head, ignore_index, has_ignore, scratch, out, stream);
    case kMultilabel:
      return launch_binned<TT, kMultilabel>(scores, target, thr, n, num_classes, num_thr, group, groups, blocks,
                                            shared_bytes, head, ignore_index, has_ignore, scratch, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// out (2, C, T) float32: out[0] = tp, out[1] = fp. The launch shape comes from the caller
// (ops/curve_counts.py::launch_plan): `blocks` sample chunks of `chunk` samples, `threads`
// threads of `per_thread` thresholds each (1, 2, 4 or 8), `chunks_t` threshold chunks per class.
// With blocks > 1, `scratch` holds blocks * 2 * C * T floats; with blocks == 1 it is unused.
int tm_curve_counts(const void* scores, const void* pos, const void* neg, const void* thr, long long n,
                    int num_classes, int num_thr, int blocks, int threads, int per_thread, int chunks_t,
                    long long chunk, void* scratch, void* out, int device, void* stream) {
  if (n <= 0 || num_classes <= 0 || num_thr <= 0) return static_cast<int>(cudaSuccess);
  if (threads <= 0 || threads > 256 || threads % 32 != 0 || blocks <= 0 || chunks_t <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_y = num_classes * chunks_t;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows_y < 65535 ? rows_y : 65535));
  float* partial = static_cast<float*>(blocks > 1 ? scratch : out);
  const float* sc = static_cast<const float*>(scores);
  const float* po = static_cast<const float*>(pos);
  const float* ne = static_cast<const float*>(neg);
  const float* th = static_cast<const float*>(thr);
  switch (per_thread) {
    case 1: launch_partial<1>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    case 2: launch_partial<2>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    case 4: launch_partial<4>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    case 8: launch_partial<8>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  const long long rows = 2LL * num_classes * num_thr;
  const long long reduce_blocks = (rows + kReduceLanes - 1) / kReduceLanes;
  counts_reduce<<<static_cast<unsigned>(reduce_blocks), dim3(kReduceLanes, kReduceLanes), 0, s>>>(
      static_cast<const float*>(scratch), blocks, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (T, C, 2, 2) float32, [t, c, target, pred], of `kind` 0 binary ((N,) scores and target,
// C = 1), 1 multiclass ((N, C) scores, (N,) class index) or 2 multilabel ((N, C) scores and
// targets). `target_type` is 0 int32, 1 int64, 2 uint8 (bool). The thresholds are sorted
// ascending. The launch shape comes from the caller (ops/curve_counts.py::binned_plan): `groups`
// class groups of `group` classes, `blocks` sample blocks, `shared_bytes` of dynamic shared
// memory (0: the histograms live in the scratch), and `head` words of tickets before the sums in
// `scratch`, which holds head + C * 2 * (T + 1) int32 zeros and is left zeroed.
int tm_binned_confmat(const void* scores, const void* target, int target_type, int kind, long long n, int num_classes,
                      int num_thr, const void* thr, int group, int groups, int blocks, int shared_bytes, int head,
                      long long ignore_index, int has_ignore, void* scratch, void* out, int device, void* stream) {
  if (n <= 0 || num_classes <= 0 || num_thr <= 0) return static_cast<int>(cudaSuccess);
  if (group <= 0 || groups <= 0 || groups > 65535 || blocks <= 0 || head < groups || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  tm_cache::Device dev;
  const cudaError_t err = tm_cache::device(device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (target_type) {
    case 0:
      return launch_binned_kind<int>(kind, scores, target, thr, n, num_classes, num_thr, group, groups, blocks,
                                     shared_bytes, head, ignore_index, has_ignore, scratch, out, s);
    case 1:
      return launch_binned_kind<long long>(kind, scores, target, thr, n, num_classes, num_thr, group, groups, blocks,
                                           shared_bytes, head, ignore_index, has_ignore, scratch, out, s);
    case 2:
      return launch_binned_kind<unsigned char>(kind, scores, target, thr, n, num_classes, num_thr, group, groups,
                                               blocks, shared_bytes, head, ignore_index, has_ignore, scratch, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tm_curve_counts_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
