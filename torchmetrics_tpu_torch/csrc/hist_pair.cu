// K2: the weighted histogram pair and the curve sketch's update, for Hopper (sm_90a).
//
// Replaces torchmetrics_tpu/ops/pallas_hist.py::_hist_pair_kernel (entry hist_pair_pallas). That
// kernel compares every 1024-bin block with every 4096-sample tile; here each sample is read once
// and added to its bin with an atomic. Two entries, each one launch per call that writes every
// element of its output: no fill before it, no cast or add after it.
//
// tm_hist_pair: for an index stream idx (int32 or int64) and two float32 weight streams pos and
// neg (neg may be null, a zero stream),
//
//   out[0, b] = sum_i pos[i] * [idx[i] == b],   out[1, b] = sum_i neg[i] * [idx[i] == b]
//
// for b in [0, length); other indices are dropped, range-checked in 64 bits before any narrowing.
//
//   - Shared branch (2 * length floats fit a block's opt-in shared memory: 28,928 bins on an H100).
//     Each block adds into a private pair in shared memory, then adds its non-zero bins into float
//     sums in a global scratch and takes a ticket after a __threadfence(). The block that draws
//     the last ticket writes all 2 * length bins from the sums and sets the sums and the ticket
//     back to 0, so the next call on the stream, and a CUDA-graph replay, find them clean. The
//     wrapper keeps that scratch per device and stream (ops/bincount.py::zeroed_scratch). A grid
//     of one block writes the output directly.
//   - Global branch (longer pairs: the weighted confusion count at C = 1000 has 1M bins). The C
//     entry zeroes the output with cudaMemsetAsync on the caller's stream, then each weight is a
//     float atomicAdd straight into the output: one device operation more.
//
//   Contract on order: float atomics add in an order that changes from run to run. With 0/1
//   weights each bin's sums are integers below 2^24, exact in any order, so the result is exact
//   and repeatable. General weights give sums whose last bits may differ between runs.
//
// tm_sketch_update: the curve sketch's whole update, new = old + this batch's histograms, from the
// raw inputs. For float32 scores s and a raw int32 or int64 target, each element that is not
// ignored (target == ignore_index) falls in bucket clamp(floor(s * (bins - 1)), 0, bins - 1),
// with NaN -> 0 (the float32 product and floor of ops/hist_pair.py::score_bucket, bit for bit: no
// fast math), and adds its weights there:
//
//   binary      (N,) scores and target: positive mass t, negative mass 1 - t;
//   multiclass  (N, C) scores, (N,) class index: for class column c, [t == c] and [t != c];
//   micro       the same one-vs-rest pairs of every column, into one (bins,) pair;
//   multilabel  (N, C) scores and targets: t and 1 - t of each element's own target.
//
//   The target is cast to int32 as the unfused chain does (target.to(torch.int32)), after the
//   ignore_index compare. Every weight is then an integer, so the update counts in int32, exactly
//   and in any order, and writes new = old + float(count): bit for bit the chain's
//   pos_hist + dp while a bucket's batch count stays below 2^24.
//
//   Design. The counts are a histogram of (class, bucket, pos|neg) with few enough words for shared
//   memory, so the skeleton is K1's (csrc/bincount.cu), with the state cut into slices:
//   - the state's (class, bucket) words are cut into `slices` contiguous slices over blockIdx.y;
//     block (x, y) reads sample share x of the class columns that slice y covers (every column
//     for micro) and counts the elements whose word falls in the slice;
//   - each block keeps int32 [pos|neg] x slice tables in shared memory: one per group of warps while
//     several copies fit in the default 48 KB, so that warps on the same hot bucket (scores piled
//     at 0 or 1) do not queue on one word. A 0/1 target is one shared atomic per element; a target
//     that validation would refuse (possible with validate_args=False) adds t and 1 - t;
//   - across blocks: each block adds its non-zero counts into int32 sums in the scratch and takes
//     its slice's ticket; the last block of the slice reads the sums (clearing them), adds them to
//     the old state and writes the slice's new state, 8 words a thread at a time;
//   - the slice count: that last block finishes its slice alone, at one SM's rate, and every slice
//     re-reads the batch. A small batch against a wide state (path D: 10,000 x 5 scores, 5 x 2048
//     buckets) wants many slices, a large batch (2^26 scores) one. The host picks the count that
//     minimises the sum of both costs (launch_sketch); a state wider than shared memory is simply
//     cut into more slices, so the tables never leave shared memory;
//   - each thread keeps 4 elements' loads in flight (K1's design).
//   Why not 16 + 16-bit packed counters: they would halve the table but need a flush before a
//   counter can overflow, and cannot hold a target outside {0, 1}.
//
// Bound on the card: HBM bytes. hist_pair reads 12 (int32 index) to 16 B per sample; the sketch
// reads 4 B of score and 4 or 8 B of target per element and 8 B of old state and writes 8 B of new
// state per (class, bucket). Device attributes and occupancy are queried once per device and
// kernel (device_cache.cuh), not on every call.
//
// Plain C interface, loaded with ctypes: each entry returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include <math.h>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// shared memory kept free of the dynamic tables, for the kernels' own words
constexpr int kStaticBytes = 1024;
// several copies of a sketch table while they fit in the default 48 KB of shared memory
constexpr int kSubHistBytes = 48 * 1024;
// words of hist_pair's scratch before its cross-block sums; word 0 is the ticket
constexpr int kScratchHead = 32;
// words each thread of the last block reads at once from the sums: its pass over the whole
// output then waits on one L2 round trip per kBatch * kThreads words, not per kThreads
constexpr int kBatch = 8;
// the fewest state words of a sketch slice (one per thread of each plane), and the cost of
// finishing one word of a slice in the last block, in bytes of batch the card re-reads meanwhile:
// on an H100 one SM finishes a word (old state and sums read, new state written, sums cleared) in
// about 0.8 ns, in which the card re-reads about 8 KB of a batch that its 50 MB L2 holds (2.7 KB at
// the HBM rate of 3.35 TB/s, and about three times that from L2)
constexpr int kMinSpan = 512;
constexpr double kFinishBytesPerWord = 8000.0;

enum Kind { kBinary = 0, kMulticlass = 1, kMicro = 2, kMultilabel = 3 };

int shared_bins_max(const tm_cache::Device& dev) {
  return (dev.smem_optin - kStaticBytes) / static_cast<int>(2 * sizeof(float));
}

long long blocks_wanted(long long work) { return (work + kThreads * kUnroll - 1) / (kThreads * kUnroll); }

// ------------------------------------------------------------------ hist_pair

template <typename T>
__device__ __forceinline__ int bin_of(const T* __restrict__ idx, long long i, long long length) {
  const long long v = static_cast<long long>(idx[i]);
  return (v >= 0 && v < length) ? static_cast<int>(v) : -1;
}

__device__ __forceinline__ void add_pair(float* hist, int length, int b, float p, float q) {
  if (b < 0) return;
  if (p != 0.f) atomicAdd(&hist[b], p);
  if (q != 0.f) atomicAdd(&hist[length + b], q);
}

// Adds the weights of every kept sample of [0, n) to hist ([0, length): pos, then neg), over a
// grid-stride loop with kUnroll samples' loads in flight per thread.
template <typename T>
__device__ __forceinline__ void pair_count(const T* __restrict__ idx, const float* __restrict__ pos,
                                           const float* __restrict__ neg, long long n, int length, float* hist) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int b[kUnroll];
    float p[kUnroll];
    float q[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      b[k] = bin_of(idx, i + k * stride, length);
      p[k] = pos[i + k * stride];
      q[k] = neg != nullptr ? neg[i + k * stride] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) add_pair(hist, length, b[k], p[k], q[k]);
  }
  for (; i < n; i += stride) add_pair(hist, length, bin_of(idx, i, length), pos[i], neg != nullptr ? neg[i] : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pair_shared(const T* __restrict__ idx, const float* __restrict__ pos,
                                                        const float* __restrict__ neg, long long n, int length,
                                                        float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float hist[];  // [0, length): pos, [length, 2 * length): neg, as out
  __shared__ int last;
  const int words = 2 * length;
  for (int w = threadIdx.x; w < words; w += blockDim.x) hist[w] = 0.f;
  __syncthreads();
  pair_count(idx, pos, neg, n, length, hist);
  __syncthreads();
  if (gridDim.x == 1) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) out[w] = hist[w];
    return;
  }
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  float* sums = scratch + kScratchHead;  // the int32 zeros of the scratch read as float zeros
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const float h = hist[w];
    if (h != 0.f) atomicAdd(&sums[w], h);
  }
  __threadfence();  // this block's sums are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int base = threadIdx.x; base < words; base += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int w = base + k * blockDim.x;
      v[k] = w < words ? __ldcg(&sums[w]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int w = base + k * blockDim.x;
      if (w < words) {
        out[w] = v[k];
        sums[w] = 0.f;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pair_global(const T* __restrict__ idx, const float* __restrict__ pos,
                                                        const float* __restrict__ neg, long long n, int length,
                                                        float* __restrict__ out) {
  pair_count(idx, pos, neg, n, length, out);
}

template <typename T>
int launch_pair(const T* idx, const float* pos, const float* neg, long long n, int length, float* scratch, float* out,
                int device, cudaStream_t stream) {
  if (n <= 0 || length <= 0) return static_cast<int>(cudaSuccess);
  tm_cache::Device dev;
  cudaError_t err = tm_cache::device(device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = blocks_wanted(n);
  if (length <= shared_bins_max(dev)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(2) * length * sizeof(float);
    int per_sm = 0;
    err = tm_cache::blocks_per_sm(pair_shared<T>, device, dev, kThreads, smem, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(dev.sms) * per_sm;
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    pair_shared<T><<<grid, kThreads, smem, stream>>>(idx, pos, neg, n, length, scratch, out);
  } else {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(2) * length * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(dev.sms) * (2048 / kThreads);
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    pair_global<T><<<grid, kThreads, 0, stream>>>(idx, pos, neg, n, length, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ sketch_update

template <typename TT>
struct SketchInput {
  const float* __restrict__ scores;
  const TT* __restrict__ target;
  long long n;      // samples
  int num_classes;  // columns of scores and of a multilabel target; 1 for binary
  int bins;
  int state;        // words of one plane of the state: classes of the state x bins
  long long ignore_index;
  int has_ignore;
};

// floor(s * (bins - 1)) in float32, NaN -> 0, clamped to [0, bins - 1]; the product is rounded on
// its own (no contraction), as ops/hist_pair.py::score_bucket computes it
__device__ __forceinline__ int bucket_of(float s, int bins) {
  const float top = static_cast<float>(bins - 1);
  float f = floorf(__fmul_rn(s, top));
  if (isnan(f)) return 0;
  f = fminf(fmaxf(f, 0.f), top);
  return static_cast<int>(f);
}

template <typename TT>
__device__ __forceinline__ bool ignored(const SketchInput<TT>& in, long long label) {
  return in.has_ignore && label == in.ignore_index;
}

// One element into the block's table, if its state word `f` lies in the slice [w0, w0 + plane):
// the word of positive mass is table[f - w0], the word of negative mass `plane` words after it.
template <int KIND>
__device__ __forceinline__ void add_element(int* table, int plane, int w0, int f, int t, int column) {
  const int local = f - w0;
  if (local < 0 || local >= plane) return;
  int* pos = table + local;
  if (KIND == kMulticlass || KIND == kMicro) {
    atomicAdd(t == column ? pos : pos + plane, 1);
  } else if (t == 0 || t == 1) {
    atomicAdd(t ? pos : pos + plane, 1);
  } else {  // a target that validation would refuse still adds t and 1 - t, as the unfused chain does
    atomicAdd(pos, t);
    atomicAdd(pos + plane, 1 - t);
  }
}

// Counts the elements of the block's share of the samples whose state word falls in its slice,
// reading the class columns [c0, c0 + classes) of each sample.
template <typename TT, int KIND>
__device__ __forceinline__ void sketch_count(const SketchInput<TT>& in, int c0, int classes, int* table, int plane,
                                             int w0) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (KIND == kBinary) {
    for (; i + (kUnroll - 1) * stride < in.n; i += kUnroll * stride) {
      float s[kUnroll];
      long long label[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        s[k] = in.scores[i + k * stride];
        label[k] = static_cast<long long>(in.target[i + k * stride]);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (!ignored(in, label[k]))
          add_element<KIND>(table, plane, w0, bucket_of(s[k], in.bins), static_cast<int>(label[k]), 0);
      }
    }
    for (; i < in.n; i += stride) {
      const long long label = static_cast<long long>(in.target[i]);
      if (!ignored(in, label)) add_element<KIND>(table, plane, w0, bucket_of(in.scores[i], in.bins), static_cast<int>(label), 0);
    }
    return;
  }
  // class kinds: a thread takes one sample and walks the slice's class columns, kUnroll columns'
  // loads in flight at a time; the row's scores share cache lines, so the strided loads cost one
  // sector fetch per row
  for (; i < in.n; i += stride) {
    long long label = 0;
    if (KIND != kMultilabel) {
      label = static_cast<long long>(in.target[i]);
      if (ignored(in, label)) continue;
    }
    const long long row = i * in.num_classes + c0;
    for (int cj0 = 0; cj0 < classes; cj0 += kUnroll) {
      float s[kUnroll];
      long long lab[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (cj0 + k < classes) {
          s[k] = in.scores[row + cj0 + k];
          lab[k] = KIND == kMultilabel ? static_cast<long long>(in.target[row + cj0 + k]) : label;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = c0 + cj0 + k;
        if (cj0 + k >= classes || (KIND == kMultilabel && ignored(in, lab[k]))) continue;
        const int f = (KIND == kMicro ? 0 : c * in.bins) + bucket_of(s[k], in.bins);
        add_element<KIND>(table, plane, w0, f, static_cast<int>(lab[k]), c);
      }
    }
  }
}

// Block (x, y) counts sample share x of slice y of the state: the words [w0, w0 + span) of each
// plane. `copies` tables of [pos | neg] x slice words sit in shared memory.
template <typename TT, int KIND>
__global__ void __launch_bounds__(kThreads) sketch_update(SketchInput<TT> in, int span, int copies,
                                                          const float* __restrict__ pos_old,
                                                          const float* __restrict__ neg_old, int* __restrict__ scratch,
                                                          int head, float* __restrict__ out) {
  extern __shared__ int tables[];
  __shared__ int last;
  const int w0 = blockIdx.y * span;
  const int plane = min(span, in.state - w0);  // words of one plane of this slice
  const int words = 2 * plane;
  // the class columns the slice needs: those of its classes, or every column for micro
  constexpr bool kPerClass = KIND == kMulticlass || KIND == kMultilabel;
  const int c0 = kPerClass ? w0 / in.bins : 0;
  const int classes = kPerClass ? (w0 + plane - 1) / in.bins - c0 + 1 : in.num_classes;
  for (int w = threadIdx.x; w < copies * words; w += blockDim.x) tables[w] = 0;
  __syncthreads();
  sketch_count<TT, KIND>(in, c0, classes, tables + (threadIdx.x / 32 % copies) * words, plane, w0);
  __syncthreads();
  int* sums = scratch + head;  // [pos | neg] x state words, int32, as the output
  // word w of the slice's table is word `at(w)` of the state, the output and the sums
  auto at = [&](int w) { return w < plane ? w0 + w : in.state + w0 + (w - plane); };
  auto copies_sum = [&](int w) {
    int v = 0;
    for (int k = 0; k < copies; ++k) v += tables[k * words + w];
    return v;
  };
  const bool direct = gridDim.x == 1;  // this block's tables are the slice's whole count
  if (!direct) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      const int v = copies_sum(w);
      if (v != 0) atomicAdd(&sums[at(w)], v);
    }
    __threadfence();  // this block's sums are visible before its ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(reinterpret_cast<unsigned*>(scratch) + blockIdx.y, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  for (int base = threadIdx.x; base < words; base += kBatch * blockDim.x) {
    int v[kBatch];
    float old[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int w = base + k * blockDim.x;
      if (w < words) {
        const int g = at(w);
        v[k] = direct ? copies_sum(w) : __ldcg(&sums[g]);
        old[k] = g < in.state ? pos_old[g] : neg_old[g - in.state];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int w = base + k * blockDim.x;
      if (w < words) {
        const int g = at(w);
        out[g] = old[k] + static_cast<float>(v[k]);
        if (!direct) sums[g] = 0;
      }
    }
  }
  if (!direct && threadIdx.x == 0) scratch[blockIdx.y] = 0;
}

// The launch shape. The last block of a slice finishes the slice alone (old state and sums read,
// new state written, sums cleared), at one SM's rate, while every slice re-reads the batch at the
// card's rate: `slices` minimises slices * batch bytes + kFinishBytesPerWord * slice words,
// within [the fewest whose tables fit shared memory, one per kMinSpan words].
template <typename TT, int KIND>
int launch_sketch(const SketchInput<TT>& in, const float* pos_old, const float* neg_old, int* scratch, int head,
                  float* out, int device, cudaStream_t stream) {
  tm_cache::Device dev;
  cudaError_t err = tm_cache::device(device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fit = (dev.smem_optin - kStaticBytes) / (2 * sizeof(int));  // slice words a table holds
  const long long fewest = (in.state + fit - 1) / fit;
  const long long spans = (in.state + kMinSpan - 1) / kMinSpan;
  const long long most = spans < 65535 ? spans : 65535;  // blockIdx.y
  const bool per_class_target = KIND == kMultilabel;
  const double batch_bytes = static_cast<double>(in.n) * in.num_classes * sizeof(float) +
                             static_cast<double>(in.n) * (per_class_target ? in.num_classes : 1) * sizeof(TT);
  long long slices = llround(sqrt(kFinishBytesPerWord * in.state / batch_bytes));
  slices = slices < fewest ? fewest : (slices > most ? (most > fewest ? most : fewest) : slices);
  const int span = static_cast<int>((in.state + slices - 1) / slices);
  slices = (in.state + span - 1) / span;  // no empty slice
  if (slices > head || slices > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long table = 2LL * span * sizeof(int);
  const long long fit_copies = kSubHistBytes / table;
  const int copies = static_cast<int>(fit_copies < 1 ? 1 : (fit_copies > kWarps ? kWarps : fit_copies));
  const size_t smem = static_cast<size_t>(copies * table);
  int per_sm = 0;
  err = tm_cache::blocks_per_sm(sketch_update<TT, KIND>, device, dev, kThreads, smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // elements a slice reads per sample: its classes' columns (at most span / bins + 1), all of micro's
  const long long columns = KIND == kBinary ? 1
                            : KIND == kMicro ? in.num_classes
                                             : (span / in.bins + 2 < in.num_classes ? span / in.bins + 2 : in.num_classes);
  const long long wanted = blocks_wanted(in.n * columns);
  const long long resident = static_cast<long long>(dev.sms) * per_sm / slices;
  const long long blocks = wanted < resident ? wanted : (resident > 0 ? resident : 1);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  sketch_update<TT, KIND><<<grid, kThreads, smem, stream>>>(in, span, copies, pos_old, neg_old, scratch, head, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TT>
int launch_sketch_kind(int kind, const SketchInput<TT>& in, const float* pos_old, const float* neg_old, int* scratch,
                       int head, float* out, int device, cudaStream_t stream) {
  switch (kind) {
    case kBinary: return launch_sketch<TT, kBinary>(in, pos_old, neg_old, scratch, head, out, device, stream);
    case kMulticlass: return launch_sketch<TT, kMulticlass>(in, pos_old, neg_old, scratch, head, out, device, stream);
    case kMicro: return launch_sketch<TT, kMicro>(in, pos_old, neg_old, scratch, head, out, device, stream);
    case kMultilabel: return launch_sketch<TT, kMultilabel>(in, pos_old, neg_old, scratch, head, out, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Bins the shared branch of tm_hist_pair holds on `device`; longer pairs take the global branch.
int tm_hist_pair_shared_bins_max(int device, int* bins) {
  tm_cache::Device dev;
  const cudaError_t err = tm_cache::device(device, &dev);
  *bins = err == cudaSuccess ? shared_bins_max(dev) : 0;
  return static_cast<int>(err);
}

// out (2, length) float32 = the weighted histograms of idx under pos and neg (neg may be null). The
// shared branch needs `scratch`: 32 + 2 * length int32 zeros, left zeroed.
int tm_hist_pair(const void* idx, int idx_is_int64, const void* pos, const void* neg, long long n, int length,
                 void* scratch, void* out, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* q = static_cast<const float*>(neg);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  if (idx_is_int64) return launch_pair(static_cast<const long long*>(idx), p, q, n, length, sc, o, device, s);
  return launch_pair(static_cast<const int*>(idx), p, q, n, length, sc, o, device, s);
}

// out (2, K, bins) float32: out[0] = pos_old + this batch's positive counts, out[1] = neg_old + its
// negative counts, where K = C for kind 1 (multiclass) and 3 (multilabel) and 1 for kind 0
// (binary) and 2 (micro). scores are (n,) for binary, else (n, C); the target (int32, or int64
// when target_is_int64) is (n, C) for multilabel, else (n,). `scratch` holds head + 2 * K * bins
// int32 zeros and is left zeroed; its first `head` words are the slices' tickets: at least
// min(ceil(K * bins / 512), 65535), one for each slice there can be.
int tm_sketch_update(const void* scores, const void* target, int target_is_int64, int kind, long long n,
                     int num_classes, int bins, long long ignore_index, int has_ignore, const void* pos_old,
                     const void* neg_old, void* scratch, int head, void* out, int device, void* stream) {
  if (n <= 0 || num_classes <= 0 || bins <= 0 || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  const float* po = static_cast<const float*>(pos_old);
  const float* ne = static_cast<const float*>(neg_old);
  int* scr = static_cast<int*>(scratch);
  float* o = static_cast<float*>(out);
  const long long state = static_cast<long long>(kind == kMulticlass || kind == kMultilabel ? num_classes : 1) * bins;
  if (2 * state + head > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int words = static_cast<int>(state);
  if (target_is_int64) {
    const SketchInput<long long> in{sc, static_cast<const long long*>(target), n, num_classes, bins, words,
                                    ignore_index, has_ignore};
    return launch_sketch_kind(kind, in, po, ne, scr, head, o, device, s);
  }
  const SketchInput<int> in{sc, static_cast<const int*>(target), n, num_classes, bins, words, ignore_index, has_ignore};
  return launch_sketch_kind(kind, in, po, ne, scr, head, o, device, s);
}

const char* tm_hist_pair_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
