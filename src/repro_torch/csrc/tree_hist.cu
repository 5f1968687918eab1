// GBDT histograms for the device fit of src/repro_torch/core/gbdt.py:
//
//   repro_tree_hist   replaces src/repro/kernels/tree_hist.py::tree_hist
//                     (pl.pallas_call at tree_hist.py:78): per sampled
//                     feature column c and row r with node[r] >= 0,
//                     out[{g,h}, node[r], feat_ids[c], codes[c, r]] += {g,h}[r];
//   repro_cumsum_seq  replaces the sequential prefix sum of the reference's
//                     device fit (src/repro/core/gbdt.py::_cumsum_seq, an
//                     XLA loop; not a Pallas kernel): a left fold per row.
//
// Bit parity is the requirement.  The device fit must export the forest
// the host fit exports, and the host adds every histogram segment
// (node, feature, bin) as an f32 left fold in ascending row order
// (np.add.at) and every prefix sum as a left fold over the bins
// (np.cumsum).  A float atomicAdd would add in no fixed order, so neither
// kernel uses one.
//
// tree_hist design.  One block per (sampled column, tile of 4096 segments;
// segment = node * num_bins + bin), 8 warps.  Warp w owns the segments s
// of the tile with s % 8 == w and keeps their G and H in shared memory.
// Row tiles of (segment, g, h) are staged in shared memory; every warp
// walks each staged tile in 32-row steps, one row a lane, in row order. In
// a step, each lane whose row falls in one of the warp's segments writes
// its lane id into a tag slot of that segment and reads it back: if every
// such lane reads its own id, the step's segments are distinct and each
// lane adds its row to its segment (a fold of one row).  If not, the lanes
// group themselves by segment with __match_any_sync and the lowest lane of
// each set folds the set's rows in lane order from registers, four
// shuffles in flight at a time: acc = ((acc + g[r0]) + g[r1]) + ...; where
// a set holds more than 8 rows (the skewed case) every leader walks all 32
// lanes unrolled and adds those of its set.  Sets of one step hold
// distinct segments, so their folds never collide.  No two warps touch one
// segment, and each segment sees its rows in ascending order, one add at a
// time: the host's fold, bit for bit, with no float atomic.  The old
// design (one thread a segment) made every thread inspect every row; here
// a warp inspects 32 rows a step, so a block issues R / 32 steps per warp
// instead of R per thread, and the tag test spares __match_any_sync
// wherever the step's segments are distinct.
//
// Bound on H100: bytes (each column's codes, the node ids, g and h read
// once, the histograms written once).  The time of a skewed column is set
// by its longest segment's fold, which the contract makes serial.
//
// At most 32 segments per column (the leaf sums: 1 column, 32 nodes, 1
// bin) would leave 4 segments to a warp and a clash in most steps (on an
// NVIDIA H100 80GB HBM3 at 700 W, tree_hist_kernel took 2.0x the time of
// the kernel below on uniform leaves; PERF.md section 6). There a
// block of 16 warps stages 2048 rows at a time and records, for each
// 32-row step and segment, the mask of the step's lanes in that segment
// (integer atomicOr of the lanes' bits, which is exact in any order); one
// thread a segment (two a warp) then folds it by walking the masks in row
// order (a step holding more than 8 of its rows is read whole, 32
// independent loads, and its rows added under the mask).  Splitting a
// column's rows over blocks would need their partial sums added
// afterwards, which is not the host's left fold, so a segment is always
// folded by one thread or warp.
// The output (including the all-zero unsampled features) is zeroed by the
// wrapper; each block writes its column's panel into feat_ids[c].
//
// cumsum_seq design.  One block per 32 rows: a 32 x 256 slice is staged in
// shared memory with coalesced loads, one thread per row folds its slice
// serially (starting from -0.0, the additive identity, so out[0] == x[0]
// as in np.cumsum), and the slice is written back coalesced.
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // segment owners: segment % 8
constexpr int kSegTile = 4096;  // segments of one block: 32 KB of G and H
constexpr int kRowTile = 1024;  // staged rows: 12 KB
// G, H and tag slots of a segment tile and the staged rows: 60 KB
constexpr size_t kSmem = 3 * kSegTile * 4 + 3 * kRowTile * 4;
constexpr int kBatch = 4;  // fold rounds per batch of shuffles
constexpr int kSmallThreads = 512;
constexpr int kSmallRows = 2048;  // staged rows of the small kernel: 16 KB + 8 KB of masks
constexpr int kDense = 8;  // a step with more of a segment's rows is folded whole
constexpr int kScanRows = 32;

__global__ void __launch_bounds__(kThreads)
tree_hist_kernel(const int* __restrict__ codes_t, const int* __restrict__ feat_ids,
                 const int* __restrict__ node, const float* __restrict__ g,
                 const float* __restrict__ h, float* __restrict__ out, int R, int nodes,
                 int F, int B) {
  extern __shared__ float smem[];
  float* s_g_acc = smem;                                   // kSegTile
  float* s_h_acc = s_g_acc + kSegTile;                     // kSegTile
  volatile int* s_tag = reinterpret_cast<volatile int*>(s_h_acc + kSegTile);  // kSegTile
  int* s_seg = reinterpret_cast<int*>(s_h_acc + 2 * kSegTile);  // kRowTile
  float* s_g = reinterpret_cast<float*>(s_seg + kRowTile);      // kRowTile
  float* s_h = s_g + kRowTile;                                   // kRowTile
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int seg0 = blockIdx.y * kSegTile;
  const int tile = min(kSegTile, nodes * B - seg0);
  for (int s = tid; s < kSegTile; s += kThreads) {
    s_g_acc[s] = 0.f;
    s_h_acc[s] = 0.f;
  }
  const int* col = codes_t + (size_t)c * R;
  for (int r0 = 0; r0 < R; r0 += kRowTile) {
    const int n = min(kRowTile, R - r0);
    __syncthreads();  // the previous tile's walk is done
    for (int i = tid; i < n; i += kThreads) {
      const int r = r0 + i;
      const int nd = node[r];
      const int code = col[r];
      int s = -1;
      if (nd >= 0 && code >= 0 && code < B) {
        s = nd * B + code - seg0;
        if (s >= tile) s = -1;
      }
      s_seg[i] = s;
      s_g[i] = g[r];
      s_h[i] = h[r];
    }
    __syncthreads();
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int s = i < n ? s_seg[i] : -1;
      const bool mine = s >= 0 && (s & (kWarps - 1)) == warp;
      if (__ballot_sync(kFull, mine) == 0u) continue;
      const float gv = mine ? s_g[i] : 0.f;
      const float hv = mine ? s_h[i] : 0.f;
      // clash test: lanes of one segment overwrite each other's tag
      if (mine) s_tag[s] = lane;
      __syncwarp();
      if (!__any_sync(kFull, mine && s_tag[s] != lane)) {  // distinct segments
        if (mine) {
          s_g_acc[s] += gv;
          s_h_acc[s] += hv;
        }
        __syncwarp();
        continue;
      }
      const unsigned peers = __match_any_sync(kFull, mine ? s : -1 - lane);
      const int size = mine ? __popc(peers) : 0;
      const int rounds = (int)__reduce_max_sync(kFull, (unsigned)size);
      const bool leader = mine && (peers & lt) == 0u;
      float ag = 0.f, ah = 0.f;
      if (leader) {
        ag = s_g_acc[s];
        ah = s_h_acc[s];
      }
      if (rounds > kBatch * 2) {  // a large set (the skewed case): all 32 lanes
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float tg = __shfl_sync(kFull, gv, k);
          const float th = __shfl_sync(kFull, hv, k);
          if ((peers >> k) & 1u) {
            ag += tg;
            ah += th;
          }
        }
      } else {
        unsigned rest = leader ? peers : 0u;  // the set's lanes, ascending
        for (int k = 0; k < rounds; k += kBatch) {  // kBatch shuffles in flight
          float tg[kBatch], th[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int src = rest ? __ffs(rest) - 1 : lane;
            rest &= rest - 1u;
            tg[q] = __shfl_sync(kFull, gv, src);
            th[q] = __shfl_sync(kFull, hv, src);
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            if (k + q < size) {
              ag += tg[q];
              ah += th[q];
            }
          }
        }
      }
      if (leader) {
        s_g_acc[s] = ag;
        s_h_acc[s] = ah;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const size_t fid = (size_t)feat_ids[c];
  const size_t half = (size_t)nodes * F * B;
  for (int s = tid; s < tile; s += kThreads) {
    const int seg = seg0 + s;
    const size_t at = ((size_t)(seg / B) * F + fid) * B + (seg % B);
    out[at] = s_g_acc[s];
    out[half + at] = s_h_acc[s];
  }
}

// Rows k of one 32-row step with bit k of m set, added to acc = (G, H) in
// row order: all 32 loads first (out of line, so that the sparse walk
// beside it does not pay for them).
__device__ __noinline__ float2 fold_dense(unsigned m, const float* sg, const float* sh,
                                          float2 acc) {
  float vg[32], vh[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    vg[k] = sg[k];
    vh[k] = sh[k];
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((m >> k) & 1u) {
      acc.x += vg[k];
      acc.y += vh[k];
    }
  }
  return acc;
}

// At most 32 segments (the leaf sums): thread 16 s folds segment s, two
// folding threads a warp.
__global__ void __launch_bounds__(kSmallThreads)
tree_hist_small_kernel(const int* __restrict__ codes_t, const int* __restrict__ feat_ids,
                       const int* __restrict__ node, const float* __restrict__ g,
                       const float* __restrict__ h, float* __restrict__ out, int R,
                       int nodes, int F, int B) {
  constexpr int kWarpsSmall = kSmallThreads / 32;
  constexpr int kStepsPerWarp = kSmallRows / 32 / kWarpsSmall;
  __shared__ unsigned s_mask[kSmallRows / 32][32];  // [step][segment]: its lanes
  __shared__ float s_g[kSmallRows];
  __shared__ float s_h[kSmallRows];
  const int S = nodes * B;
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x / 16;  // the segment this thread folds, if a folder
  const bool folder = (threadIdx.x & 15) == 0 && seg < S;
  const int* col = codes_t + (size_t)c * R;
  float ag = 0.f, ah = 0.f;
  for (int r0 = 0; r0 < R; r0 += kSmallRows) {
    const int n = min(kSmallRows, R - r0);
    __syncthreads();  // the previous tile's fold is done
    for (int i = threadIdx.x; i < kSmallRows / 32 * 32; i += kSmallThreads)
      (&s_mask[0][0])[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kStepsPerWarp; ++q) {  // every load of the tile in flight
      const int i = (warp + q * kWarpsSmall) * 32 + lane;
      int s = -1;
      if (i < n) {
        const int r = r0 + i;
        const int nd = node[r];
        const int code = col[r];
        if (nd >= 0 && code >= 0 && code < B) s = nd * B + code;
        if (s >= S) s = -1;
        s_g[i] = g[r];
        s_h[i] = h[r];
      }
      if (s >= 0) atomicOr(&s_mask[warp + q * kWarpsSmall][s], 1u << lane);
    }
    __syncthreads();
    if (folder) {
      const int steps = (n + 31) / 32;
      for (int step = 0; step < steps; ++step) {
        unsigned m = s_mask[step][seg];
        if (__popc(m) > kDense) {
          const float2 acc = fold_dense(m, s_g + step * 32, s_h + step * 32,
                                        make_float2(ag, ah));
          ag = acc.x;
          ah = acc.y;
          continue;
        }
        while (m) {  // the step's rows of this segment, in row order
          const int j = __ffs(m) - 1;
          m &= m - 1u;
          ag += s_g[step * 32 + j];
          ah += s_h[step * 32 + j];
        }
      }
    }
  }
  if (folder) {
    const size_t fid = (size_t)feat_ids[c];
    const size_t at = ((size_t)(seg / B) * F + fid) * B + (seg % B);
    out[at] = ag;
    out[(size_t)nodes * F * B + at] = ah;
  }
}

__global__ void __launch_bounds__(kThreads)
cumsum_kernel(const float* __restrict__ x, float* __restrict__ out, int M, int L) {
  __shared__ float s_x[kScanRows][kThreads + 1];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kScanRows;
  const int rows = min(kScanRows, M - row0);
  float run = -0.f;  // thread t < rows folds row row0 + t
  for (int l0 = 0; l0 < L; l0 += kThreads) {
    const int w = min(kThreads, L - l0);
    if (tid < w)
      for (int r = 0; r < rows; ++r) s_x[r][tid] = x[(size_t)(row0 + r) * L + l0 + tid];
    __syncthreads();
    if (tid < rows)
      for (int j = 0; j < w; ++j) {
        run += s_x[tid][j];
        s_x[tid][j] = run;
      }
    __syncthreads();
    if (tid < w)
      for (int r = 0; r < rows; ++r) out[(size_t)(row0 + r) * L + l0 + tid] = s_x[r][tid];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int repro_tree_hist(const int* codes_t, const int* feat_ids, const int* node, const float* g,
                    const float* h, float* out, int R, int C, int nodes, int F, int B,
                    void* stream) {
  if (R < 0 || C < 0 || nodes < 1 || F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if ((long long)nodes * B >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return (int)cudaGetLastError();
  if (nodes * B <= 32) {
    tree_hist_small_kernel<<<C, kSmallThreads, 0, (cudaStream_t)stream>>>(
        codes_t, feat_ids, node, g, h, out, R, nodes, F, B);
    return (int)cudaGetLastError();
  }
  per_device::allow_smem(tree_hist_kernel, kSmem);
  dim3 grid(C, (nodes * B + kSegTile - 1) / kSegTile);
  tree_hist_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(codes_t, feat_ids, node, g,
                                                                   h, out, R, nodes, F, B);
  return (int)cudaGetLastError();
}

int repro_cumsum_seq(const float* x, float* out, int M, int L, void* stream) {
  if (M < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || L == 0) return (int)cudaGetLastError();
  cumsum_kernel<<<(M + kScanRows - 1) / kScanRows, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, M, L);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
