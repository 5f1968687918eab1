// Masked group aggregation for the query-eval driver's no-predicate launches:
//
//   repro_group_aggregate  replaces src/repro/kernels/groupagg.py::
//                          group_aggregate (pl.pallas_call at groupagg.py:63):
//                          out[b, v, g] = sum_r values[b, v, r] * mask[b, r]
//                                                 * 1[codes[b, r] == g]
//
// Bound on H100: memory.  Each row costs V + 2 reads of 4 bytes (mask,
// code, V components) and V adds; the output is V * radix floats per
// stack row.
//
// Design.  The aggregation is groupagg.cuh's (shared with fused_eval):
// warp-private float4 accumulators over the whole radix, lanes owning rows,
// a tag test for slices with distinct codes and a fixed pairwise tree
// through __match_any_sync for equal ones, and a combine in warp order;
// its comment states the order of addition and why a stack row's result
// depends only on its own data.  The block holds as many warps as fit in
// about 112 KB (three at radix 2048: two blocks an SM), or one block an SM
// where two warps would not fit.  This kernel adds the row stream: the
// mask, code and components of a warp step's 8 slices sit in registers,
// and each slice's slot is refilled with the same slice of the warp's next
// step as soon as it is read.  (__match_any_sync costs more the more
// distinct codes the warp holds; the tag test spares it where codes are
// spread out.)  The f32 sums are within the port's "sums" tolerance of the
// plain version (rtol 1e-5, atol 1e-4: another order of addition).
//
// Semantics kept from the reference: a row with a zero mask, or with a
// code outside [0, radix), adds nothing; a row that passes adds
// values[v] * mask.  The ragged row edge is masked here.
#include <cuda_runtime.h>

#include "groupagg.cuh"

namespace {

using agg::kVT;
using agg::kRowsPerLane;
using agg::kStep;

struct Stage {
  float m[kRowsPerLane];
  int k[kRowsPerLane];
  float x[kVT][kRowsPerLane];
};

// slice j of the step at base: row base + j * 32 + lane, coalesced across
// the warp; rows past R load as dropped rows
__device__ __forceinline__ void load_slice(Stage& s, int j, const float* __restrict__ mb,
                                           const int* __restrict__ cb,
                                           const float* __restrict__ vb, int vt, int R,
                                           int base, int lane) {
  const int row = base + j * 32 + lane;
  const bool in = row < R;
  s.m[j] = in ? mb[row] : 0.f;
  s.k[j] = in ? cb[row] : -1;
#pragma unroll
  for (int c = 0; c < kVT; ++c) s.x[c][j] = (in && c < vt) ? vb[(size_t)c * R + row] : 0.f;
}

__global__ void __launch_bounds__(agg::kMaxWarps * 32)
groupagg_kernel(const float* __restrict__ values,  // (B, V, R)
                const float* __restrict__ mask,    // (B, R)
                const int* __restrict__ codes,     // (B, R)
                float* __restrict__ out,           // (B, V, radix)
                int V, int R, int radix, int tile) {
  extern __shared__ float4 acc_all[];  // warps x tile codes x kVT components, then tags
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t b = blockIdx.x;
  const int g0 = blockIdx.y * tile;
  const int gw = min(tile, radix - g0);
  const int v0 = blockIdx.z * kVT;
  const int vt = min(kVT, V - v0);
  float4* acc = acc_all + (size_t)warp * tile;
  volatile int* tags = agg::tags_of(acc_all, warps, tile);

  agg::zero(acc_all, warps, tile);
  __syncthreads();

  const float* mb = mask + b * R;
  const int* cb = codes + b * R;
  const float* vb = values + (b * V + v0) * (size_t)R;
  const int stride = warps * kStep;
  int base = warp * kStep;
  Stage st;  // a rolling window of kRowsPerLane slices in flight
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) load_slice(st, j, mb, cb, vb, vt, R, base, lane);
  for (; base < R; base += stride) {
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const float m = st.m[j];
      const int code = st.k[j] - g0;
      const int key = (m != 0.f && code >= 0 && code < gw) ? code : -1;
      float x[kVT];
#pragma unroll
      for (int c = 0; c < kVT; ++c) x[c] = st.x[c][j] * m;
      // refill the slot with slice j of this warp's next step
      load_slice(st, j, mb, cb, vb, vt, R, base + stride, lane);
      agg::slice(acc, tags, key, x, lane);
    }
  }
  __syncthreads();
  agg::store(acc_all, warps, tile, gw, vt, out, b, V, v0, radix, g0);
}

}  // namespace

extern "C" {

int repro_group_aggregate(const float* values, const float* mask, const int* codes,
                          float* out, int B, int V, int R, int radix, void* stream) {
  if (V < 1 || V > agg::kMaxComponents || R < 0 || radix < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const agg::Geometry geo = agg::geometry(V, radix);
  static size_t smem_allowed = 48 * 1024;  // raised once, as far as a launch needs
  if (geo.smem > smem_allowed) {
    cudaFuncSetAttribute(groupagg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)geo.smem);
    smem_allowed = geo.smem;
  }
  groupagg_kernel<<<agg::grid(B, V, radix, geo), geo.warps * 32, geo.smem,
                    (cudaStream_t)stream>>>(values, mask, codes, out, V, R, radix, geo.tile);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
