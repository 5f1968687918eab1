// Per-partition counting passes of the sketch ingest:
//
//   repro_moments          replaces src/repro/kernels/moments.py::moments
//                          (pl.pallas_call at moments.py:72): min, max, sum,
//                          sum of squares of x and of log(max(x, 1e-30));
//   repro_histogram_range  replaces src/repro/kernels/histogram.py::
//                          histogram_range (pl.pallas_call at histogram.py:60):
//                          equi-depth bucket counts against per-partition edges;
//   repro_bincount         replaces src/repro/kernels/histogram.py::bincount
//                          (pl.pallas_call at histogram.py:96): exact code counts.
//
// Bound on H100: memory.  Each pass reads its (P, R) column once (4 bytes
// a row); outputs are (P, 8), (P, NB) and (P, card) floats.  The
// instructions a value costs decide whether the byte rate is reachable:
// moments spends one full-precision logf a value, histogram_range a compare
// and an add per edge.  Measured on an NVIDIA H100 80GB HBM3 at 700 W at
// 1024 x 16384 (tools/sass_loops.py, tools/ab_ingest.py): moments' loop
// issues 36 SASS instructions a value, 0.018 ms at the issue rate against
// 0.020 ms of bytes, and runs in 0.029 ms; histogram_range's cumulative
// loop at NB = 10 issues 25 a value, 0.012 ms, and runs in 0.028 ms.  The
// TPU kernels counted through one-hot matmuls on the MXU; here counts are
// whole numbers in registers or shared memory, exact in any order.
//
// moments.  One block of 256 threads per partition; thread t folds values
// t, t + 256, t + 512, ... of its row in that order (one chain a sum), then
// a fixed shuffle tree and a warp-order combine.  That order is kept on
// purpose: the sums feed the picker's features, and another order (four
// chains a thread over 16-byte groups was tried) moves the answers.  It
// depends on R only, so a 16-row launch gives the rows a 1024-row launch
// gives (the streaming delta == cold contract).  The row is read 16 values
// a thread at a time, 4-byte loads that a warp coalesces into 128-byte
// lines, and the next 16 load while these fold.  Per value: min and max without NaN tests, two sums of x, one
// logf, min and max of the log and two sums of it.  NaN needs no test in
// the loop: the sum of squares is NaN exactly when a value is NaN (squares
// add no inf - inf), and then min, max and the log statistics are set to
// NaN at the end, as jnp.min/jnp.max propagate it.
//
// histogram_range.  NB <= 16 runs an instance compiled for its NB (the
// callers use 10); larger NB, up to 4096, the general kernel at the end.
// A partition is split over a cluster of up to 8 blocks when the launch has
// fewer than two blocks an SM (16 partitions: 8 blocks each), since
// integer counts do not depend on the split; rank 0 adds the blocks' counts
// through distributed shared memory.  Every thread keeps its counters in
// registers and reads 16-byte groups (a scalar head and tail align them).
// A partition whose own NB + 1 edges are nondecreasing and NaN-free takes
// the cumulative path: counter j holds the values >= edge j (j < NB) and
// one more the values > the top edge, so bucket k is c[k] - c[k + 1] and
// the closed last bucket c[NB - 1] - c[NB] (duplicate edges give empty
// buckets, as the reference's test does): one compare and one add a value
// and edge, NB + 1 of each, against two compares and an add a bucket.  Any
// other partition (unsorted or NaN edges are legal too) takes the
// reference's own test of each bucket, lo <= v < hi with the last bucket
// closed.  Both give the reference's counts; NaN values count nowhere.
// Warps add their counters with __reduce_add_sync and shared atomics.
//
// bincount.  One block per partition and bin tile of 4096 streams its row
// into an integer histogram in shared memory with atomics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;        // values a moments thread loads at once
constexpr int kStep = 4;        // float4 groups a histogram thread loads at once
constexpr int kBinTile = 4096;  // bins of one bincount block (16 KB of counters)
constexpr int kSmallNB = 16;    // largest NB with an instance of its own
constexpr int kMaxNB = 4096;
constexpr int kMaxCluster = 8;
constexpr int kMinGroups = 2;  // float4 groups a thread of a split partition keeps
constexpr int kFillBlocks = 2 * 132;  // two blocks an SM of an H100 SXM
constexpr float kTiny = 1e-30f;

// --------------------------------------------------------------------------
// moments
// --------------------------------------------------------------------------
struct Moments {
  float mn, mx, s, ss, lmn, lmx, ls, lss;
};

__device__ __forceinline__ void fold(float v, Moments& m) {
  m.mn = fminf(m.mn, v);  // drops NaN; restored from ss at the end
  m.mx = fmaxf(m.mx, v);
  m.s += v;
  m.ss = fmaf(v, v, m.ss);
  const float l = logf(fmaxf(v, kTiny));  // NaN -> log(1e-30), also restored
  m.lmn = fminf(m.lmn, l);
  m.lmx = fmaxf(m.lmx, l);
  m.ls += l;
  m.lss = fmaf(l, l, m.lss);
}

__device__ __forceinline__ Moments combine(Moments a, const Moments& b) {
  a.mn = fminf(a.mn, b.mn);
  a.mx = fmaxf(a.mx, b.mx);
  a.s += b.s;
  a.ss += b.ss;
  a.lmn = fminf(a.lmn, b.lmn);
  a.lmx = fmaxf(a.lmx, b.lmx);
  a.ls += b.ls;
  a.lss += b.lss;
  return a;
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int d) {
  Moments o;
  o.mn = __shfl_down_sync(kFull, m.mn, d);
  o.mx = __shfl_down_sync(kFull, m.mx, d);
  o.s = __shfl_down_sync(kFull, m.s, d);
  o.ss = __shfl_down_sync(kFull, m.ss, d);
  o.lmn = __shfl_down_sync(kFull, m.lmn, d);
  o.lmx = __shfl_down_sync(kFull, m.lmx, d);
  o.ls = __shfl_down_sync(kFull, m.ls, d);
  o.lss = __shfl_down_sync(kFull, m.lss, d);
  return o;
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ x, float* __restrict__ out, int R) {
  __shared__ Moments s_warp[kWarps];
  const size_t p = blockIdx.x;
  const float* xp = x + p * R;
  const int t = threadIdx.x;
  Moments m = {INFINITY, -INFINITY, 0.f, 0.f, INFINITY, -INFINITY, 0.f, 0.f};
  // values t, t + 256, t + 512, ... in that order, kRun at a time, the next
  // run loading while this one folds
  const int runs = R / (kRun * kThreads);
  float v[kRun];
  if (runs > 0) {
#pragma unroll
    for (int u = 0; u < kRun; ++u) v[u] = __ldg(xp + t + u * kThreads);
  }
  for (int k = 0; k < runs; ++k) {
    float w[kRun];
    const float* next = xp + (size_t)(k + 1) * kRun * kThreads + t;
    if (k + 1 < runs) {
#pragma unroll
      for (int u = 0; u < kRun; ++u) w[u] = __ldg(next + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kRun; ++u) fold(v[u], m);
#pragma unroll
    for (int u = 0; u < kRun; ++u) v[u] = w[u];
  }
  for (int i = runs * kRun * kThreads + t; i < R; i += kThreads) fold(__ldg(xp + i), m);

  for (int d = 16; d > 0; d >>= 1) m = combine(m, shfl_down(m, d));
  if ((t & 31) == 0) s_warp[t >> 5] = m;
  __syncthreads();
  if (t == 0) {
    Moments s = s_warp[0];
    for (int w = 1; w < kWarps; ++w) s = combine(s, s_warp[w]);
    if (s.ss != s.ss) s.mn = s.mx = s.lmn = s.lmx = s.ls = s.lss = s.ss;  // a NaN value
    float* o = out + p * 8;
    o[0] = s.mn;
    o[1] = s.mx;
    o[2] = s.s;
    o[3] = s.ss;
    o[4] = s.lmn;
    o[5] = s.lmx;
    o[6] = s.ls;
    o[7] = s.lss;
  }
}

// --------------------------------------------------------------------------
// histogram_range, NB <= 16
// --------------------------------------------------------------------------
// Folds float4 groups first + t, first + t + kThreads, ... (< last) of
// thread t in that order, kStep groups at a time, loading the next step
// while it folds this one.
template <typename Fold>
__device__ __forceinline__ void stream(const float4* __restrict__ body, int first, int last,
                                       Fold fold) {
  const int t = threadIdx.x;
  const int steps = (last - first) / (kStep * kThreads);  // steps with kStep groups a thread
  float4 v[kStep];
  if (steps > 0) {
#pragma unroll
    for (int u = 0; u < kStep; ++u) v[u] = __ldg(body + first + t + u * kThreads);
  }
  for (int k = 0; k < steps; ++k) {
    float4 w[kStep];
    const float4* next = body + first + (k + 1) * kStep * kThreads + t;
    if (k + 1 < steps) {
#pragma unroll
      for (int u = 0; u < kStep; ++u) w[u] = __ldg(next + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u) fold(v[u]);
#pragma unroll
    for (int u = 0; u < kStep; ++u) v[u] = w[u];
  }
  for (int q = first + steps * kStep * kThreads + t; q < last; q += kThreads)
    fold(__ldg(body + q));
}

// Counters are floats: the FP32 add issues on the FMA pipe while the
// compares take the ALU pipe, and a thread's count (at most R / 256 + 1)
// is exact in f32.

// cumulative counters of one value: c[j] += (v >= e[j]) for j < NB, and
// c[NB] += (v > e[NB]); NaN compares false
template <int NB>
__device__ __forceinline__ void cumulative(float v, const float* e, float* c) {
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j] += (float)(v >= e[j]);
  c[NB] += (float)(v > e[NB]);
}

// the reference's test of each bucket: lo <= v < hi, the last bucket closed
template <int NB>
__device__ __forceinline__ void each(float v, const float* e, float* c) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const bool in = v >= e[k] && (k == NB - 1 ? v <= e[k + 1] : v < e[k + 1]);
    c[k] += (float)in;
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
histogram_small_kernel(const float* __restrict__ x, const float* __restrict__ edges,
                       float* __restrict__ out, int R) {
  __shared__ int s_cnt[NB + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t p = blockIdx.x / S;
  const int t = threadIdx.x;
  float e[NB + 1];
#pragma unroll
  for (int j = 0; j <= NB; ++j) e[j] = __ldg(edges + p * (NB + 1) + j);
  bool sorted = true;
#pragma unroll
  for (int j = 0; j < NB; ++j) sorted &= e[j] <= e[j + 1];  // false on a NaN edge
  if (t <= NB) s_cnt[t] = 0;

  // the row as a scalar head, 16-byte groups, a scalar tail; the groups are
  // cut into S contiguous slices, the head and tail go to rank 0
  const float* xp = x + p * R;
  const int head = min(R, (int)((16 - ((uintptr_t)xp & 15)) & 15) >> 2);
  const float4* body = reinterpret_cast<const float4*>(xp + head);
  const int n4 = (R - head) >> 2;
  const int per = (n4 + S - 1) / S;
  const int q0 = min(n4, rank * per), q1 = min(n4, q0 + per);
  const int tail0 = head + 4 * n4;
  float loose = NAN;  // this thread's value of the head or tail, if any
  if (rank == 0) {
    if (t < head) loose = __ldg(xp + t);
    else if (t - head < R - tail0) loose = __ldg(xp + tail0 + t - head);
  }

  float c[NB + 1] = {};
  if (sorted) {
    stream(body, q0, q1, [&](float4 v) {
      cumulative<NB>(v.x, e, c);
      cumulative<NB>(v.y, e, c);
      cumulative<NB>(v.z, e, c);
      cumulative<NB>(v.w, e, c);
    });
    cumulative<NB>(loose, e, c);
  } else {
    stream(body, q0, q1, [&](float4 v) {
      each<NB>(v.x, e, c);
      each<NB>(v.y, e, c);
      each<NB>(v.z, e, c);
      each<NB>(v.w, e, c);
    });
    each<NB>(loose, e, c);
  }

  __syncthreads();  // s_cnt zeroed
#pragma unroll
  for (int j = 0; j <= NB; ++j) {
    const int w = __reduce_add_sync(kFull, (int)c[j]);
    if ((t & 31) == 0 && w != 0) atomicAdd(&s_cnt[j], w);
  }
  if (S == 1) {
    __syncthreads();
  } else {
    cluster.sync();  // every block's counts are in its shared memory
    if (rank == 0 && t <= NB) {
      int total = 0;
      for (int r = 0; r < S; ++r) total += cluster.map_shared_rank(s_cnt, r)[t];
      s_cnt[t] = total;  // only rank 0 reads its own s_cnt after this sync
    }
    cluster.sync();  // ranks keep their shared memory until rank 0 has read it
  }
  if (rank == 0 && t < NB) {
    const int k = sorted ? s_cnt[t] - s_cnt[t + 1] : s_cnt[t];
    out[p * NB + t] = (float)k;
  }
}

// --------------------------------------------------------------------------
// histogram_range, general NB (<= 4096): one block per partition, edges and
// integer counters in shared memory, shared atomics
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const float* __restrict__ x, const float* __restrict__ edges,
                 float* __restrict__ out, int R, int NB) {
  extern __shared__ float s_edges[];  // NB + 1 edges, then NB int counters
  int* s_cnt = reinterpret_cast<int*>(s_edges + NB + 1);
  const size_t p = blockIdx.x;
  for (int k = threadIdx.x; k <= NB; k += kThreads) s_edges[k] = edges[p * (NB + 1) + k];
  for (int k = threadIdx.x; k < NB; k += kThreads) s_cnt[k] = 0;
  __syncthreads();
  const float* xp = x + p * R;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const float v = xp[i];
    for (int k = 0; k < NB; ++k) {
      // lo <= v < hi; the last bucket also takes v == hi; NaN takes none
      const float lo = s_edges[k], hi = s_edges[k + 1];
      if (v >= lo && (v < hi || (k == NB - 1 && v <= hi))) atomicAdd(&s_cnt[k], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NB; k += kThreads) out[p * NB + k] = (float)s_cnt[k];
}

// --------------------------------------------------------------------------
// bincount
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
bincount_kernel(const int* __restrict__ codes, float* __restrict__ out, int R, int card) {
  __shared__ unsigned s_cnt[kBinTile];
  const size_t p = blockIdx.x;
  const int c0 = blockIdx.y * kBinTile;
  const int w = min(kBinTile, card - c0);
  for (int k = threadIdx.x; k < w; k += kThreads) s_cnt[k] = 0u;
  __syncthreads();
  const int* cp = codes + p * R;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int c = cp[i] - c0;  // -1 padding and codes >= card count nowhere
    if (c >= 0 && c < w) atomicAdd(&s_cnt[c], 1u);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < w; k += kThreads) out[p * card + c0 + k] = (float)s_cnt[k];
}

// blocks a partition of histogram_small_kernel: doubled up to 8 while the
// launch has fewer than two blocks an SM and each block keeps at least
// kMinGroups float4 groups a thread
int cluster_size(int P, int R) {
  int S = 1;
  while (S < kMaxCluster && (long long)P * S < kFillBlocks &&
         R / (2 * S) >= 4 * kMinGroups * kThreads)
    S *= 2;
  return S;
}

template <int NB>
cudaError_t launch_small(const float* x, const float* edges, float* out, int P, int R,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const int S = cluster_size(P, R);
  cfg.gridDim = dim3((unsigned)P * S);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, histogram_small_kernel<NB>, x, edges, out, R);
}

template <int NB>
cudaError_t dispatch_small(int nb, const float* x, const float* edges, float* out, int P,
                           int R, cudaStream_t stream) {
  if constexpr (NB > kSmallNB) {
    return cudaErrorInvalidValue;
  } else {
    if (nb == NB) return launch_small<NB>(x, edges, out, P, R, stream);
    return dispatch_small<NB + 1>(nb, x, edges, out, P, R, stream);
  }
}

}  // namespace

extern "C" {

int repro_moments(const float* x, float* out, int P, int R, void* stream) {
  if (P < 0 || R < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  moments_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(x, out, R);
  return (int)cudaGetLastError();
}

int repro_histogram_range(const float* x, const float* edges, float* out, int P, int R,
                          int NB, void* stream) {
  if (P < 0 || R < 0 || NB < 1 || NB > kMaxNB) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  if (NB <= kSmallNB) {
    const cudaError_t err = dispatch_small<1>(NB, x, edges, out, P, R, (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  const size_t smem = (size_t)(2 * NB + 1) * sizeof(float);
  histogram_kernel<<<P, kThreads, smem, (cudaStream_t)stream>>>(x, edges, out, R, NB);
  return (int)cudaGetLastError();
}

int repro_bincount(const int* codes, float* out, int P, int R, int card, void* stream) {
  if (P < 0 || R < 0 || card < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  dim3 grid(P, (card + kBinTile - 1) / kBinTile);
  bincount_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(codes, out, R, card);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // namespace extern "C"
