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
// segment = node * num_bins + bin).  Thread t owns the segments s of the
// tile with s % 256 == t and keeps their G and H in shared memory.  Row
// tiles of (segment, g, h) are staged in shared memory; every thread walks
// each staged tile in row order and adds the rows that fall in its own
// segments.  No two threads touch one segment, and each segment sees its
// rows in ascending order: the host's fold, bit for bit.  Bound on H100:
// operations, not bytes — every thread inspects every row of its column
// (R * 256 compares per column), against R * 16 bytes read per column.
// The output (including the all-zero unsampled features) is zeroed by the
// wrapper; each block writes its column's panel into feat_ids[c].
//
// cumsum_seq design.  One block per 32 rows: a 32 x 256 slice is staged in
// shared memory with coalesced loads, one thread per row folds its slice
// serially (starting from -0.0, the additive identity, so out[0] == x[0]
// as in np.cumsum), and the slice is written back coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegTile = 4096;  // segments of one block: 32 KB of G and H
constexpr int kRowTile = 1024;  // staged rows: 12 KB
constexpr int kScanRows = 32;

__global__ void __launch_bounds__(kThreads)
tree_hist_kernel(const int* __restrict__ codes_t, const int* __restrict__ feat_ids,
                 const int* __restrict__ node, const float* __restrict__ g,
                 const float* __restrict__ h, float* __restrict__ out, int R, int nodes,
                 int F, int B) {
  __shared__ float s_g_acc[kSegTile];
  __shared__ float s_h_acc[kSegTile];
  __shared__ int s_seg[kRowTile];
  __shared__ float s_g[kRowTile];
  __shared__ float s_h[kRowTile];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
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
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const int s = s_seg[i];
      if (s >= 0 && (s & (kThreads - 1)) == tid) {
        s_g_acc[s] += s_g[i];
        s_h_acc[s] += s_h[i];
      }
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
  dim3 grid(C, (nodes * B + kSegTile - 1) / kSegTile);
  tree_hist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(codes_t, feat_ids, node, g, h,
                                                               out, R, nodes, F, B);
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
