// The masked segment sum that group_aggregate (groupagg.cu) and fused_eval
// (eval.cu) share: their launch geometry, the fold of one 32-row slice into
// a warp's accumulator, and the combine of the warps' accumulators.  Both
// kernels add in the one order written down here, so fused_eval with a
// predicate every row passes gives group_aggregate's bits for a mask of
// ones.
//
// A block works on one (stack row b, group tile, component tile of four).
// Each warp keeps a private accumulator in shared memory, one float4 of
// components per code of the tile (at the shapes queries/device.py
// launches, V <= 4 and radix <= 4096, the tile is the whole radix and there
// is one component tile, so every stack row is streamed once), and the
// block keeps one int tag slot per code.  Lanes own rows: warp w takes the
// 256-row steps w, w + W, w + 2W, ... of its stack row, each as 8 slices of
// 32 rows (row base + 32 j + lane), in order.
//
// A slice is folded in by `slice`: every lane with a live row writes its
// thread id into the tag slot of its code, loads its code's accumulator
// and reads the tag back.  If no lane of the warp reads another id, the
// slice's codes are distinct and each lane stores its accumulator plus its
// row.  Otherwise (equal codes in the slice, or another warp wrote the slot
// in between) the lanes group themselves by code with __match_any_sync,
// each set of equal codes is summed by a fixed pairwise tree over its
// members in lane order (log2 of the set's size shuffle rounds), and the
// lowest lane of the set adds the sum.  With distinct codes both ways add
// the same values to the same slots, so which way a slice takes changes
// its cost, never its bits.  Sets in one slice hold distinct codes, so the
// adds never collide, and no float atomic is used.
//
// Order of addition: within a slice, the rows of one code form a pairwise
// tree in lane order; slices are added to the warp's accumulator in row
// order; `store` adds the warps' accumulators in warp order, from warp 0
// (a thread per code, reading each warp's float4).  Every choice in that
// order (tile, warps per block, step) depends on V and radix only
// (`geometry`), so a stack row's result depends only on its own data: not
// on B, on the other rows of the launch, or on padding.  It is the same
// bits from run to run, and a 16-row delta launch gives the rows a full
// launch gives.  Counts (component 0 is 1.0 for every row) are sums of
// integers, exact in f32 below 2^24 rows.
//
// Rows are not split over blocks.  A cluster of up to 8 blocks per stack
// row, combined through distributed shared memory, made the 16-row launches
// 1.7 to 3.3 times faster at narrow radixes but the 1024-row ones up to 1.7
// times slower (radix 4: 0.167 -> 0.279 ms on an NVIDIA H100 80GB HBM3 at
// 700 W), and a split that must not depend on B cannot tell the two apart.
#pragma once
#include <cuda_runtime.h>

namespace agg {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kVT = 4;                 // components of one component tile
constexpr int kMaxComponents = 32;
constexpr int kRowsPerLane = 8;        // a warp step is 32 * 8 = 256 rows
constexpr int kStep = 32 * kRowsPerLane;
constexpr size_t kBlockTarget = 112 * 1024;  // two blocks an SM
constexpr size_t kSmemMax = 220 * 1024;      // one block at most

struct Geometry {
  int tile;     // codes of one group tile
  int warps;    // warps of one block, each with its own accumulator
  size_t smem;  // dynamic shared memory of one block
};

// Every choice depends on V and radix only: a stack row's result must not
// depend on B.
inline Geometry geometry(int V, int radix) {
  (void)V;  // one float4 of components per code, whatever V
  const size_t col = sizeof(float4);
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
  return {tile, warps, per_warp * warps + tags};
}

// grid of a launch over B stack rows
inline dim3 grid(int B, int V, int radix, const Geometry& g) {
  return dim3(B, (radix + g.tile - 1) / g.tile, (V + kVT - 1) / kVT);
}

// the tag slots: tile ints after the block's warp accumulators
__device__ __forceinline__ volatile int* tags_of(float4* acc_all, int warps, int tile) {
  return reinterpret_cast<volatile int*>(acc_all + (size_t)warps * tile);
}

__device__ __forceinline__ void zero(float4* acc_all, int warps, int tile) {
  for (int i = threadIdx.x; i < warps * tile; i += blockDim.x)
    acc_all[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// fold one 32-row slice into this warp's accumulator: key is the lane's
// code within the tile, or -1 for a row that adds nothing; x its components
__device__ __forceinline__ void slice(float4* acc, volatile int* tags, int key,
                                      float (&x)[kVT], int lane) {
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
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
    return;
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

// after a __syncthreads: out[b, v0 + c, g0 + g] = the warps' sums in warp
// order; a thread per code adds the warps' float4s (16-byte reads, no bank
// conflicts) and stores its vt components
__device__ __forceinline__ void store(const float4* acc_all, int warps, int tile, int gw,
                                      int vt, float* __restrict__ out, size_t b, int V,
                                      int v0, int radix, int g0) {
  for (int g = threadIdx.x; g < gw; g += blockDim.x) {
    float4 s = acc_all[g];
    for (int w = 1; w < warps; ++w) {
      const float4 a = acc_all[(size_t)w * tile + g];
      s = make_float4(s.x + a.x, s.y + a.y, s.z + a.z, s.w + a.w);
    }
    const float sv[kVT] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int c = 0; c < kVT; ++c)
      if (c < vt) out[(b * V + v0 + c) * radix + g0 + g] = sv[c];
  }
}

}  // namespace agg
