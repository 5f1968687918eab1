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
// a row) and does a few operations per row; outputs are (P, 8), (P, NB)
// and (P, card) floats.
//
// Design.  One block per partition (per partition and bin tile for a wide
// bincount) streams its row with coalesced loads.  The TPU kernels counted
// through one-hot matmuls on the MXU; here counts go straight into an
// integer histogram in shared memory with integer atomics, which are exact
// in any order.  moments has no float atomics: every thread folds a fixed
// strided subset of the row, then a fixed shuffle tree and a warp-order
// combine give the same sums on every run.  min and max propagate NaN, as
// jnp.min/jnp.max do; log takes max(x, 1e-30) with NaN kept.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBinTile = 4096;  // bins of one bincount block (16 KB of counters)
constexpr float kTiny = 1e-30f;

// NaN-propagating min/max (fminf/fmaxf would drop a NaN operand)
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

struct Moments {
  float mn, mx, s, ss, lmn, lmx, ls, lss;
};

__device__ __forceinline__ Moments combine(Moments a, const Moments& b) {
  a.mn = nan_min(a.mn, b.mn);
  a.mx = nan_max(a.mx, b.mx);
  a.s += b.s;
  a.ss += b.ss;
  a.lmn = nan_min(a.lmn, b.lmn);
  a.lmx = nan_max(a.lmx, b.lmx);
  a.ls += b.ls;
  a.lss += b.lss;
  return a;
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int d) {
  Moments o;
  o.mn = __shfl_down_sync(0xffffffffu, m.mn, d);
  o.mx = __shfl_down_sync(0xffffffffu, m.mx, d);
  o.s = __shfl_down_sync(0xffffffffu, m.s, d);
  o.ss = __shfl_down_sync(0xffffffffu, m.ss, d);
  o.lmn = __shfl_down_sync(0xffffffffu, m.lmn, d);
  o.lmx = __shfl_down_sync(0xffffffffu, m.lmx, d);
  o.ls = __shfl_down_sync(0xffffffffu, m.ls, d);
  o.lss = __shfl_down_sync(0xffffffffu, m.lss, d);
  return o;
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ x, float* __restrict__ out, int R) {
  __shared__ Moments s_warp[kWarps];
  const size_t p = blockIdx.x;
  const float* xp = x + p * R;
  Moments m = {INFINITY, -INFINITY, 0.f, 0.f, INFINITY, -INFINITY, 0.f, 0.f};
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const float v = xp[i];
    const float l = logf(v != v ? v : fmaxf(v, kTiny));
    m.mn = nan_min(m.mn, v);
    m.mx = nan_max(m.mx, v);
    m.s += v;
    m.ss += v * v;
    m.lmn = nan_min(m.lmn, l);
    m.lmx = nan_max(m.lmx, l);
    m.ls += l;
    m.lss += l * l;
  }
  for (int d = 16; d > 0; d >>= 1) m = combine(m, shfl_down(m, d));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments t = s_warp[0];
    for (int w = 1; w < kWarps; ++w) t = combine(t, s_warp[w]);
    float* o = out + p * 8;
    o[0] = t.mn;
    o[1] = t.mx;
    o[2] = t.s;
    o[3] = t.ss;
    o[4] = t.lmn;
    o[5] = t.lmx;
    o[6] = t.ls;
    o[7] = t.lss;
  }
}

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
  if (P < 0 || R < 0 || NB < 1 || NB > 4096) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
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

}  // extern "C"
