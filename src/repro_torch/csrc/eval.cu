// Predicate-masked group aggregation for the query evaluation of queries/device.py:
//
//   repro_fused_eval       replaces src/repro/kernels/fused.py::fused_eval
//                          (pl.pallas_call at fused.py:84): AND-of-ORs
//                          interval predicate folded into the group codes,
//                          then masked segment sums.
//
// The predicate-free launch (repro_group_aggregate) has a kernel of its
// own in groupagg.cu; both fold rows with groupagg.cuh.
//
// Bound on H100: memory.  Every row costs C clause reads of 4 bytes and
// two compares a clause; a row that passes costs V + 1 more reads (its
// code and components) and V adds; the output is V * radix floats per
// stack row.  At the training labels' shape (1024 x 8 x 16384, few rows
// passing) the clause columns are nearly all of the 0.18 ms.
//
// Design.  groupagg.cuh's geometry: one block per (stack row b, group
// tile, component tile).  At the shapes queries/device.py launches (V <=
// 4, radix <= 4096) the tile is the whole radix, so each clause column of
// a stack row is streamed once, not once per group tile.
// Lanes own rows: warp w takes the 256-row steps w, w + W, ... of its stack
// row, 8 slices of 32 rows each.  For a step, each lane loads its 8 rows'
// clause values, up to 8 clauses at once (64 loads in flight a lane, each
// coalesced across the warp), and keeps the results in one 64-bit word a
// row, tested against each OR-group's member mask.  Only the lanes whose
// row passes load its code and components (in the instance below, every
// row's are prefetched).  Each slice with a passing row
// is then folded into the warp's accumulator by groupagg.cuh's `slice`
// (tag test, or __match_any_sync and a fixed pairwise tree), and `store`
// adds the warps' accumulators in warp order at the end.  A slice where
// no row passes adds nothing in `slice` either, so it is skipped.
//
// A second instance of the kernel loads a warp's next step (its first
// clauses, and every row's code and components) while the warp folds the
// current one; it changes which loads issue and when, never what is added.
// It holds up to 234 registers a thread, so the launcher takes it only
// where that costs no resident warps: where the grid is smaller than the
// card (the planner's 16-row chunk reads: 0.063 -> 0.050 ms at radix 8)
// and where shared memory holds an SM to 8 warps anyway (radix 2048 and
// 4096: the training-label launch 0.742 -> 0.694 ms).  Elsewhere it would
// halve the blocks an SM: a clause-only prefetch ran 1.7 times slower at
// radix 512 with half the rows passing (NVIDIA H100 80GB HBM3, 700 W,
// same-call A/Bs).
//
// Order of addition, and why the contract holds: groupagg.cuh's.  The
// tile, warps and step depend on (V, radix) only, never on B (the grid's
// size may pick the prefetching instance, which adds the same), so a stack
// row's sums depend only on its own data and on (C, G, V, R, radix): a
// 16-row delta launch gives the bits the full launch gives those rows,
// and two runs give the same bits.  fused_eval with a predicate that every
// row passes gives group_aggregate's bits for a mask of ones.  Counts
// (component 0) are exact in f32 below 2^24 rows; the f32 sums are within
// rtol 1e-5, atol 1e-4 of the plain version (another order of addition).
//
// Semantics kept from the reference: NaN data fails every interval test
// (IEEE ordered compares; no fast-math), an OR-group with no member clause
// passes no row, and a code outside [0, radix) contributes nothing.  The
// ragged row edge is masked here, so no padding is needed.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "groupagg.cuh"

namespace {

using agg::kVT;
using agg::kRowsPerLane;
using agg::kStep;

constexpr int kMaxClauses = 64;  // clause bits of one row live in a uint64
constexpr size_t kSmemPerSm = 232448;    // shared memory an SM gives its blocks
constexpr size_t kSmemPerBlock = 2048;   // a block's static shared memory and reserve

// clause values of clauses c0 .. c0 + U - 1 for the lane's 8 rows of the
// step at base (NaN past R: it fails every test)
template <int U>
__device__ __forceinline__ void load_clauses(float (&v)[U][kRowsPerLane],
                                             const float* __restrict__ xb, int c0, int R,
                                             int base, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int row = base + j * 32 + lane;
      v[u][j] = row < R ? xb[(size_t)(c0 + u) * R + row] : __int_as_float(0x7fc00000);
    }
}

template <int U>
__device__ __forceinline__ void test_clauses(unsigned long long (&bits)[kRowsPerLane],
                                             const float (&v)[U][kRowsPerLane], int c0,
                                             const float* s_lo, const float* s_hi) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float lo = s_lo[c0 + u], hi = s_hi[c0 + u];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j)
      if (v[u][j] >= lo && v[u][j] < hi) bits[j] |= 1ull << (c0 + u);
  }
}

// clause bits of clauses c0 .. c0 + U - 1: every value is loaded before any
// is compared
template <int U>
__device__ __forceinline__ void clause_bits(unsigned long long (&bits)[kRowsPerLane],
                                            const float* __restrict__ xb, int c0, int R,
                                            int base, int lane, const float* s_lo,
                                            const float* s_hi) {
  float v[U][kRowsPerLane];
  load_clauses<U>(v, xb, c0, R, base, lane);
  test_clauses<U>(bits, v, c0, s_lo, s_hi);
}

// P > 0: a warp's next step (its first P clauses, codes and components)
// is loaded while this step's rows are folded.  It changes which loads are
// issued and when, never what is added or in which order.
template <int P>
__global__ void __launch_bounds__(agg::kMaxWarps * 32, P == 0 ? 2 : 1)
eval_kernel(const float* __restrict__ x,       // (B, C, R) clause columns
            const float* __restrict__ lo,      // (B, C) inclusive bounds
            const float* __restrict__ hi,      // (B, C) exclusive bounds
            const float* __restrict__ gmap,    // (B, C, G) clause -> OR-group
            const float* __restrict__ values,  // (B, V, R) components
            const int* __restrict__ codes,     // (B, R) group codes
            float* __restrict__ out,           // (B, V, radix)
            int C, int G, int V, int R, int radix, int tile) {
  extern __shared__ float4 acc_all[];  // warps x tile codes x kVT components, then tags
  __shared__ float s_lo[kMaxClauses];
  __shared__ float s_hi[kMaxClauses];
  __shared__ unsigned long long s_members[kMaxClauses];  // per OR-group

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
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_lo[c] = lo[b * C + c];
    s_hi[c] = hi[b * C + c];
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    unsigned long long m = 0;
    for (int c = 0; c < C; ++c)
      if (gmap[(b * C + c) * G + g] > 0.f) m |= 1ull << c;
    s_members[g] = m;
  }
  __syncthreads();

  const float* xb = x + b * C * (size_t)R;
  const float* vb = values + (b * V + v0) * (size_t)R;
  const int* cb = codes + b * R;
  const int stride = warps * kStep;
  // P > 0: the next step's first P clause values, and its codes and
  // components (every row's: the pass is not known yet), load while this
  // step's rows are folded
  constexpr int kPre = P > 0 ? P : 1;
  float next_x[kPre][kRowsPerLane];
  int next_code[kRowsPerLane];
  float next_v[kRowsPerLane][kVT];
  auto prefetch = [&](int at) {
    load_clauses<kPre>(next_x, xb, 0, R, at, lane);
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int row = at + j * 32 + lane;
      next_code[j] = row < R ? cb[row] : -1;
#pragma unroll
      for (int k = 0; k < kVT; ++k)
        next_v[j][k] = (row < R && k < vt) ? vb[(size_t)k * R + row] : 0.f;
    }
  };
  if constexpr (P > 0) prefetch(warp * kStep);
  for (int base = warp * kStep; base < R; base += stride) {
    unsigned long long bits[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) bits[j] = 0ull;
    int c = 0;
    if constexpr (P > 0) {
      test_clauses<P>(bits, next_x, 0, s_lo, s_hi);
      c = P;
    }
    for (; c + 8 <= C; c += 8) clause_bits<8>(bits, xb, c, R, base, lane, s_lo, s_hi);
    if (c + 4 <= C) {
      clause_bits<4>(bits, xb, c, R, base, lane, s_lo, s_hi);
      c += 4;
    }
    for (; c < C; ++c) clause_bits<1>(bits, xb, c, R, base, lane, s_lo, s_hi);

    // codes and components of the passing rows (loaded for them only,
    // unless prefetched)
    int key[kRowsPerLane];
    float xv[kRowsPerLane][kVT];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int row = base + j * 32 + lane;
      bool pass = row < R;
      for (int g = 0; g < G; ++g) pass = pass && (bits[j] & s_members[g]) != 0ull;
      int code;
      if constexpr (P > 0)
        code = pass ? next_code[j] - g0 : -1;
      else
        code = pass ? cb[row] - g0 : -1;
      key[j] = (pass && code >= 0 && code < gw) ? code : -1;
#pragma unroll
      for (int k = 0; k < kVT; ++k) {
        if constexpr (P > 0)
          xv[j][k] = pass ? next_v[j][k] : 0.f;
        else
          xv[j][k] = (pass && k < vt) ? vb[(size_t)k * R + row] : 0.f;
      }
    }
    if constexpr (P > 0)
      if (base + stride < R) prefetch(base + stride);
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j)
      if (__any_sync(agg::kFull, key[j] >= 0)) agg::slice(acc, tags, key[j], xv[j], lane);
  }
  __syncthreads();
  agg::store(acc_all, warps, tile, gw, vt, out, b, V, v0, radix, g0);
}

template <int P>
void launch(const agg::Geometry& geo, dim3 grid, cudaStream_t stream, const float* x,
            const float* lo, const float* hi, const float* gmap, const float* values,
            const int* codes, float* out, int C, int G, int V, int R, int radix) {
  static size_t smem_allowed = 48 * 1024;  // raised once, as far as a launch needs
  if (geo.smem > smem_allowed) {
    cudaFuncSetAttribute(eval_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)geo.smem);
    smem_allowed = geo.smem;
  }
  eval_kernel<P><<<grid, geo.warps * 32, geo.smem, stream>>>(x, lo, hi, gmap, values, codes,
                                                             out, C, G, V, R, radix, geo.tile);
}

}  // namespace

extern "C" {

int repro_fused_eval(const float* x, const float* lo, const float* hi, const float* gmap,
                     const float* values, const int* codes, float* out, int B, int C,
                     int G, int V, int R, int radix, void* stream) {
  if (C < 0 || C > kMaxClauses || G < 0 || G > kMaxClauses || V < 1 ||
      V > agg::kMaxComponents || R < 0 || radix < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const agg::Geometry geo = agg::geometry(V, radix);
  const dim3 grid = agg::grid(B, V, radix, geo);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // the prefetching instance (up to 234 registers a thread) where it costs
  // no resident warps: the grid leaves SMs idle (the planner's 16-row chunk
  // reads), or shared memory already holds an SM to 8 warps of this
  // geometry (radix 2048 and 4096)
  const int blocks_per_sm = (int)(kSmemPerSm / (geo.smem + kSmemPerBlock));
  const bool prefetch = (long long)grid.x * grid.y * grid.z < sms ||
                        geo.warps * blocks_per_sm <= 8;
  const int pre = !prefetch ? 0 : C >= 8 ? 8 : C >= 4 ? 4 : C >= 1 ? 1 : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto kernel_p) {
    constexpr int kP = decltype(kernel_p)::value;
    launch<kP>(geo, grid, s, x, lo, hi, gmap, values, codes, out, C, G, V, R, radix);
  };
  switch (pre) {
    case 8: go(std::integral_constant<int, 8>()); break;
    case 4: go(std::integral_constant<int, 4>()); break;
    case 1: go(std::integral_constant<int, 1>()); break;
    default: go(std::integral_constant<int, 0>());
  }
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
