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
// Design.  One block per (stack row b, group tile, component tile of
// four); at the shapes queries/device.py launches (V <= 4, radix <= 4096)
// the group tile is the whole radix and there is one component tile, so
// every stack row is streamed once.  Each warp keeps a private accumulator
// in shared memory, one float4 of components per code, so a row's update
// is one 16-byte load and one 16-byte store; the block holds as many warps
// as fit in about 112 KB (three at radix 2048: two blocks an SM), or one
// block an SM where two warps would not fit.  Lanes own rows, not
// components: a warp step covers 256 rows, 8 slices of 32 (one row a lane,
// each load coalesced across the warp).  The mask, code and components of
// the 8 slices sit in registers, and each slice's slot is refilled with
// the same slice of the warp's next step as soon as it is read.  For each
// slice every lane with a passing row writes its thread id into a shared
// tag slot of its code, loads its code's accumulator, and reads the tag
// back.  If no lane of the warp reads another id, the slice's codes are
// distinct and each lane stores its accumulator plus its row.  Otherwise
// (equal codes in the slice, or another warp wrote the slot in between)
// the lanes group themselves by code with __match_any_sync, each set of
// equal codes is summed by a fixed pairwise tree over its members in lane
// order (log2 of the set's size shuffle rounds), and the lowest lane of
// the set adds the sum.  With distinct codes both ways add the same values
// to the same slots, so which way a slice takes changes its cost, never
// its bits.  Sets in one slice hold distinct codes, so the adds never
// collide, and no float atomic is used.  (__match_any_sync costs more the
// more distinct codes the warp holds; the tag test spares it where codes
// are spread out.)
//
// Order of addition, and why the contract holds.  Warp w of a block takes
// the steps w, w + W, w + 2W, ... of its stack row in order; within a
// 32-row slice the rows of one code form a pairwise tree in lane order;
// the slices' sums are added to the warp's accumulator in row order; at
// the end the warps' accumulators are added in warp order, from warp 0.
// Every choice in that order (tile, warps per block, step) depends on V
// and radix only, so a stack row's result depends only on its own data:
// not on B, on the other rows of the launch, or on padding.  It is the
// same bits from run to run, and a 16-row delta launch gives the rows a
// full launch gives.  Counts (component 0 is 1.0 for every row) are sums
// of integers, exact in f32 below 2^24 rows.  The f32 sums are within the
// port's "sums" tolerance of the plain version (rtol 1e-5, atol 1e-4:
// another order of addition).
//
// Semantics kept from the reference: a row with a zero mask, or with a
// code outside [0, radix), adds nothing; a row that passes adds
// values[v] * mask.  The ragged row edge is masked here.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kVT = 4;                 // components of one component tile
constexpr int kMaxComponents = 32;
constexpr int kRowsPerLane = 8;        // a warp step is 32 * 8 = 256 rows
constexpr int kStep = 32 * kRowsPerLane;
constexpr size_t kBlockTarget = 112 * 1024;  // two blocks an SM
constexpr size_t kSmemMax = 220 * 1024;      // one block at most

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

__global__ void __launch_bounds__(kMaxWarps * 32)
groupagg_kernel(const float* __restrict__ values,  // (B, V, R)
                const float* __restrict__ mask,    // (B, R)
                const int* __restrict__ codes,     // (B, R)
                float* __restrict__ out,           // (B, V, radix)
                int V, int R, int radix, int tile) {
  extern __shared__ float4 acc_all[];  // warps x tile codes x kVT components, then tags
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  const size_t b = blockIdx.x;
  const int g0 = blockIdx.y * tile;
  const int gw = min(tile, radix - g0);
  const int v0 = blockIdx.z * kVT;
  const int vt = min(kVT, V - v0);
  float4* acc = acc_all + (size_t)warp * tile;
  volatile int* tags =  // tile slots after the accumulators
      reinterpret_cast<volatile int*>(acc_all + (size_t)warps * tile);

  for (int i = threadIdx.x; i < warps * tile; i += blockDim.x)
    acc_all[i] = make_float4(0.f, 0.f, 0.f, 0.f);
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
      // clash test: a lane that reads back another thread's id shares its
      // code with another lane (or another warp wrote in between; the
      // general path below gives the same sums, so that costs time only)
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key >= 0) {
        tags[key] = threadIdx.x;
        a = acc[key];  // no other lane of a clash-free slice writes it
      }
      __syncwarp();
      const bool clash = key >= 0 && tags[key] != (int)threadIdx.x;
      if (!__any_sync(kFull, clash)) {  // distinct codes: one add each
        if (key >= 0) acc[key] = make_float4(a.x + x[0], a.y + x[1], a.z + x[2], a.w + x[3]);
        __syncwarp();
        continue;
      }
      unsigned peers = __match_any_sync(kFull, key);
      if (key < 0) peers = 1u << lane;  // dropped rows join no set
      // pairwise tree over the set in lane order: in round t the member of
      // rank r (r % 2^(t+1) == 0) adds the partial of rank r + 2^t
      int rank = __popc(peers & lt);
      unsigned up = peers & ~(lt | (1u << lane));  // members above this lane
      while (__any_sync(kFull, up != 0u)) {
        const int next_lane = __ffs(up);  // 1-based; 0 = none
        const int src = next_lane ? next_lane - 1 : lane;
#pragma unroll
        for (int c = 0; c < kVT; ++c) {
          const float t = __shfl_sync(kFull, x[c], src);
          if (next_lane) x[c] += t;
        }
        up &= ~__ballot_sync(kFull, rank & 1);  // odd ranks are spent
        rank >>= 1;
      }
      if (key >= 0 && (peers & lt) == 0u) {  // the set's lowest lane
        a = acc[key];
        acc[key] = make_float4(a.x + x[0], a.y + x[1], a.z + x[2], a.w + x[3]);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const float* accf = reinterpret_cast<const float*>(acc_all);
  for (int i = threadIdx.x; i < vt * gw; i += blockDim.x) {
    const int c = i / gw;
    const int g = i - c * gw;
    float s = accf[(size_t)g * kVT + c];
    for (int w = 1; w < warps; ++w) s += accf[((size_t)w * tile + g) * kVT + c];
    out[(b * V + v0 + c) * radix + g0 + g] = s;
  }
}

}  // namespace

extern "C" {

int repro_group_aggregate(const float* values, const float* mask, const int* codes,
                          float* out, int B, int V, int R, int radix, void* stream) {
  if (V < 1 || V > kMaxComponents || R < 0 || radix < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  // every choice below depends on V and radix only (a stack row's result
  // must not depend on B)
  const size_t col = sizeof(float4);  // one float4 of components per code
  int tile = radix;
  if ((size_t)tile * (col + sizeof(int)) > kSmemMax)
    tile = (int)(kSmemMax / (col + sizeof(int))) / 32 * 32;
  const size_t per_warp = (size_t)tile * col;
  const size_t tags = (size_t)tile * sizeof(int);
  // two blocks an SM where two warps fit in one; else one block as wide
  // as fits
  int warps = (int)((kBlockTarget - tags) / per_warp);
  if (warps < 2) warps = (int)((kSmemMax - tags) / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps + tags;
  static size_t smem_allowed = 48 * 1024;  // raised once, as far as a launch needs
  if (smem > smem_allowed) {
    cudaFuncSetAttribute(groupagg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_allowed = smem;
  }
  dim3 grid(B, (radix + tile - 1) / tile, (V + kVT - 1) / kVT);
  groupagg_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(values, mask, codes, out,
                                                                    V, R, radix, tile);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
