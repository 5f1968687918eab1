// Masked group aggregation for the query-eval driver:
//
//   repro_fused_eval       replaces src/repro/kernels/fused.py::fused_eval
//                          (pl.pallas_call at fused.py:84): AND-of-ORs
//                          interval predicate folded into the group codes,
//                          then masked segment sums.
//
// The predicate-free launch (repro_group_aggregate) has a kernel of its
// own in groupagg.cu.
//
// Bound on H100: memory.  Each row costs C + V + 1 reads of 4 bytes and a
// handful of compares; the output is V * radix floats per stack row, so
// the column stream is the whole cost (3.35 TB/s).
//
// Design.  One block per (stack row b, group tile); every block streams
// its stack row once per group tile (radix <= tile for all but the widest
// group-bys).  The TPU kernel contracted a one-hot tile on the MXU; here
// the mask and codes of 32 rows are computed one row per lane with
// coalesced loads, and only passing rows are visited.  Sums must be
// bit-identical from run to run, so there are no float atomics: each warp
// owns a private V x tile accumulator in shared memory, walks the passing
// rows of its 32-row chunk in lane order (lane v adds component v), and
// the warp accumulators are combined in warp order at the end.  Integer
// counts (component 0) are exact in f32 below 2^24 rows.
//
// Semantics kept from the reference: NaN data fails every interval test
// (IEEE ordered compares; no fast-math), an OR-group with no member clause
// passes no row, and a code outside [0, radix) contributes nothing.  The
// ragged row edge is masked here, so no padding is needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxClauses = 64;  // clause bits of one row live in a uint64
constexpr int kMaxComponents = 32;  // lane v adds component v
constexpr size_t kSmemBudget = 96 * 1024;  // accumulators of one block

__global__ void __launch_bounds__(kThreads)
eval_kernel(const float* __restrict__ x,       // (B, C, R) clause columns
            const float* __restrict__ lo,      // (B, C) inclusive bounds
            const float* __restrict__ hi,      // (B, C) exclusive bounds
            const float* __restrict__ gmap,    // (B, C, G) clause -> OR-group
            const float* __restrict__ values,  // (B, V, R) components
            const int* __restrict__ codes,     // (B, R) group codes
            float* __restrict__ out,           // (B, V, radix)
            int C, int G, int V, int R, int radix, int tile) {
  extern __shared__ float acc_all[];  // kWarps x V x tile
  __shared__ float s_lo[kMaxClauses];
  __shared__ float s_hi[kMaxClauses];
  __shared__ unsigned long long s_members[kMaxClauses];  // per OR-group

  const size_t b = blockIdx.x;
  const int g0 = blockIdx.y * tile;
  const int gw = min(tile, radix - g0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc = acc_all + (size_t)warp * V * tile;

  for (int i = threadIdx.x; i < kWarps * V * tile; i += kThreads) acc_all[i] = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    s_lo[c] = lo[b * C + c];
    s_hi[c] = hi[b * C + c];
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    unsigned long long m = 0;
    for (int c = 0; c < C; ++c)
      if (gmap[(b * C + c) * G + g] > 0.f) m |= 1ull << c;
    s_members[g] = m;
  }
  __syncthreads();

  const float* vb = values + b * V * R;
  const int* cb = codes + b * R;
  for (int base = warp * 32; base < R; base += kThreads) {
    const int row = base + lane;
    bool pass = row < R;
    int code = -1;
    if (pass) {
      const float* xb = x + b * C * R + row;
      unsigned long long bits = 0;
      for (int c = 0; c < C; ++c) {
        const float v = xb[(size_t)c * R];
        if (v >= s_lo[c] && v < s_hi[c]) bits |= 1ull << c;
      }
      for (int g = 0; g < G; ++g) pass = pass && (bits & s_members[g]) != 0ull;
      code = cb[row];
      pass = pass && code >= g0 && code < g0 + gw;
    }
    unsigned todo = __ballot_sync(0xffffffffu, pass);
    while (todo) {  // passing rows of this chunk, in lane order
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int cj = __shfl_sync(0xffffffffu, code, j) - g0;
      if (lane < V) acc[lane * tile + cj] += vb[(size_t)lane * R + base + j];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < V * gw; i += kThreads) {
    const int v = i / gw;
    const int g = i - v * gw;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += acc_all[((size_t)w * V + v) * tile + g];
    out[(b * V + v) * radix + g0 + g] = s;
  }
}

int pick_tile(int V, int radix) {
  int cap = (int)(kSmemBudget / ((size_t)kWarps * V * sizeof(float))) / 32 * 32;
  int want = (radix + 31) / 32 * 32;
  return want < cap ? want : cap;
}

}  // namespace

extern "C" {

int repro_fused_eval(const float* x, const float* lo, const float* hi, const float* gmap,
                     const float* values, const int* codes, float* out, int B, int C,
                     int G, int V, int R, int radix, void* stream) {
  if (C < 0 || C > kMaxClauses || G < 0 || G > kMaxClauses || V < 1 ||
      V > kMaxComponents || R < 0 || radix < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int tile = pick_tile(V, radix);
  const size_t smem = (size_t)kWarps * V * tile * sizeof(float);
  cudaFuncSetAttribute(eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(B, (radix + tile - 1) / tile);
  eval_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, lo, hi, gmap, values, codes, out, C, G, V, R, radix, tile);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
