// AND-of-ORs row mask and per-partition passing count:
//
//   repro_predicate_eval   replaces src/repro/kernels/predicate.py::
//                          predicate_eval (pl.pallas_call at predicate.py:79).
//
// A row passes when, for every OR-group, some member clause holds
// lo <= x < hi on that clause's column.  The mask is written as f32 0/1
// (P, R) and the passing count per partition as f32 (P,).
//
// Bound on H100: memory.  Each row reads C floats and writes one; the
// compares are a few operations a byte, so the column stream and the
// mask write are the whole cost (3.35 TB/s).
//
// Design.  One block per (partition, 256-row tile), one thread per row:
// consecutive threads read consecutive rows of each clause column, so
// every load is coalesced.  The TPU kernel OR-ed clause results through a
// max against the (C, G) one-hot and AND-ed with a min; here the C
// clause results of a row go into one 64-bit word, each OR-group is a
// 64-bit member mask built once per block in shared memory, and a row
// passes when (word & member[g]) != 0 for every g.  Counts take no
// atomics: a warp ballot + popc, a fixed-order sum of the warps into one
// integer per (partition, tile), and a second small kernel that sums a
// partition's tiles in tile order and converts to f32 (exact below 2^24
// rows).  NaN fails every interval (IEEE ordered compares, no fast-math);
// an OR-group with no member clause passes no row; with no OR-group every
// row passes.  The ragged row edge is masked here, so no padding is needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClauses = 64;  // clause bits of one row live in a uint64

__global__ void __launch_bounds__(kThreads)
predicate_kernel(const float* __restrict__ x,     // (P, C, R) clause columns
                 const float* __restrict__ lo,    // (P, C) or (C,) inclusive bounds
                 const float* __restrict__ hi,    // (P, C) or (C,) exclusive bounds
                 const float* __restrict__ gmap,  // (P, C, G) or (C, G) clause -> OR-group
                 float* __restrict__ mask,        // (P, R) f32 0/1
                 int* __restrict__ partial,       // (P, tiles) passing rows per tile
                 int C, int G, int R, int bound_pstride, int gmap_pstride) {
  __shared__ float s_lo[kMaxClauses];
  __shared__ float s_hi[kMaxClauses];
  __shared__ unsigned long long s_members[kMaxClauses];  // per OR-group
  __shared__ int s_count[kWarps];

  const size_t p = blockIdx.x;
  const int tile = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* lop = lo + p * bound_pstride;
  const float* hip = hi + p * bound_pstride;
  const float* gp = gmap + p * gmap_pstride;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    s_lo[c] = lop[c];
    s_hi[c] = hip[c];
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    unsigned long long m = 0;
    for (int c = 0; c < C; ++c)
      if (gp[(size_t)c * G + g] > 0.f) m |= 1ull << c;
    s_members[g] = m;
  }
  __syncthreads();

  const int row = tile * kThreads + threadIdx.x;
  bool pass = row < R;
  if (pass) {
    const float* xp = x + p * C * (size_t)R + row;
    unsigned long long bits = 0;
    for (int c = 0; c < C; ++c) {
      const float v = xp[(size_t)c * R];
      if (v >= s_lo[c] && v < s_hi[c]) bits |= 1ull << c;
    }
    for (int g = 0; g < G; ++g) pass = pass && (bits & s_members[g]) != 0ull;
    mask[p * R + row] = pass ? 1.f : 0.f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, pass);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) n += s_count[w];
    partial[p * gridDim.y + tile] = n;
  }
}

__global__ void count_kernel(const int* __restrict__ partial, float* __restrict__ count,
                             int P, int tiles) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int n = 0;
  for (int t = 0; t < tiles; ++t) n += partial[(size_t)p * tiles + t];
  count[p] = (float)n;
}

}  // namespace

extern "C" {

// partial: scratch of P * ceil(R / 256) ints; bound_pstride is C for
// per-partition bounds and 0 for shared ones, gmap_pstride C * G or 0.
int repro_predicate_eval(const float* x, const float* lo, const float* hi, const float* gmap,
                         float* mask, float* count, int* partial, int P, int C, int G, int R,
                         int bound_pstride, int gmap_pstride, void* stream) {
  if (P < 0 || C < 0 || C > kMaxClauses || G < 0 || G > kMaxClauses || R < 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  const int tiles = (R + kThreads - 1) / kThreads;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    predicate_kernel<<<dim3(P, tiles), kThreads, 0, s>>>(x, lo, hi, gmap, mask, partial, C, G,
                                                         R, bound_pstride, gmap_pstride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  count_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(partial, count, P, tiles);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
