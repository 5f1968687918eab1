// Pairwise squared distances of the KMeans assignment step:
//
//   repro_pdist_sq  replaces src/repro/kernels/pdist.py::pdist_sq
//                   (pl.pallas_call at pdist.py:53):
//                   out[n, k] = max(|x_n|^2 + |c_k|^2 - 2 x_n . c_k, 0).
//
// Bound on H100: operations.  At the shapes feature selection launches
// (N = 1024 candidates, K = 64, 128 or 256 centers, F = 476 features) the
// N*K*F multiply-adds in IEEE f32 outside the tensor cores (67 TFLOP/s)
// take longer than moving the N*F + K*F inputs and the N*K output: 3.7 us
// at K = 256, under 1 us at K = 64.  The reference runs the product in
// IEEE f32, so neither TF32 nor a 3xTF32 split is used, and no tensor core.
//
// Design.  One block of 8 warps per output tile of TM points x TN
// centers, the tile picked by the launcher from (N, K) alone: the largest
// of 16 x 32, 32 x 32 and 32 x 64 that still gives about one block per SM
// (at N = 1024: 16 x 32 at K = 64, 32 x 32 at K = 128, 32 x 64 at K = 256;
// 128 blocks each).  The larger the tile, the fewer times each operand row
// is read from L2 (a 16 x 32 tile reads 47 MB at K = 256 for 2 MB of
// operands) and the more FMAs each shared-memory load feeds.  F is walked
// in 128-feature chunks staged in shared memory by cp.async, three stages
// (two chunks in flight while one is multiplied).  Copies are 16 bytes
// when F % 4 == 0 and the operands are 16-byte aligned, else 4 bytes;
// features past F and rows past N or K are zero-filled.  Warp w owns
// features w*16 .. w*16+15 of every chunk, a fixed split of F.  Each lane
// holds a (TM/4) x (TN/8) register tile (rows rg + 4i, columns cg + 8j of
// the tile) and reads its operands as float4s (32 x 64: 16 shared loads
// feed 256 FMAs, issued a component at a time across the whole tile so
// consecutive FMAs are independent); staged rows are 132 floats apart, so
// the column reads of a quarter-warp hit 8 distinct 4-bank groups, and the
// row reads are broadcasts.  The warp also adds the squares of its
// features for each column (lane l: columns l, l + 32) and row (lane l <
// TM: row l) of the tile, so |x|^2 and |c|^2 come from the staged chunks,
// once per block and not once per output.  At the end the 8 warps'
// partial products and norms go through shared memory and are added in
// warp order.
//
// Order of addition, and why the contract holds.  A partial adds its
// warp's features in ascending order; the partials are added in warp order
// 0..7; then d = (|x|^2 + |c|^2) - 2 x.c.  The tile changes which block
// computes an output, never its order of addition, and every choice
// depends on N, K and F only, so two runs give the same bits.  The result
// is within (rtol 1e-4, atol 1e-3) of pdist_sq_plain (another order of f32
// sums).  NaN propagates through the clamp, as jnp.maximum does.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;              // features of one staged chunk
constexpr int kWarpF = kChunk / kWarps;  // features a warp owns per chunk
constexpr int kPitch = kChunk + 4;       // floats of one staged row
constexpr int kStages = 3;

template <int TM, int TN>
struct Tile {
  static constexpr int kVecs = TM + TN;  // staged rows per chunk
  static constexpr int kStageFloats = kVecs * kPitch;
  static constexpr size_t kSmem = (size_t)kStages * kStageFloats * sizeof(float);
  static_assert(kWarps * (TM * TN + kVecs) + kVecs <= kStages * kStageFloats,
                "the partials reuse the staging buffers");
  static_assert(TM % 4 == 0 && TM <= 32 && TN % 32 == 0, "lane layout");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage chunk ch of the tile's TM points and TN centers; row v of a stage
// is point n0 + v (v < TM) or center k0 + v - TM
template <int TM, int TN, bool kVec>
__device__ __forceinline__ void load_chunk(float* stage, const float* __restrict__ x,
                                           const float* __restrict__ c, int n0, int k0,
                                           int N, int K, int F, int ch) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kSlots = Tile<TM, TN>::kVecs * kChunk / kPer;
  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const int v = s / (kChunk / kPer);
    const int fl = (s - v * (kChunk / kPer)) * kPer;
    const int f = ch * kChunk + fl;
    const bool point = v < TM;
    const int row = point ? n0 + v : k0 + v - TM;
    const bool in = (point ? row < N : row < K) && f < F;
    const float* base = point ? x : c;
    const float* src = in ? base + (size_t)row * F + f : base;
    float* dst = stage + v * kPitch + fl;
    if (kVec)
      cp_async16(dst, src, in);
    else
      cp_async4(dst, src, in);
  }
}

__device__ __forceinline__ float sq4(float4 v, float acc) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

template <int TM, int TN, bool kVec>
__global__ void __launch_bounds__(kThreads)
pdist_kernel(const float* __restrict__ x, const float* __restrict__ c, float* __restrict__ out,
             int N, int K, int F) {
  using T = Tile<TM, TN>;
  constexpr int RI = TM / 4, CJ = TN / 8, CN = TN / 32;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;  // rows rg + 4i of the tile
  const int cg = lane & 7;   // columns cg + 8j of the tile
  const int n0 = blockIdx.y * TM, k0 = blockIdx.x * TN;
  const int chunks = (F + kChunk - 1) / kChunk;

  float prod[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) prod[i][j] = 0.f;
  float cn[CN];  // |c|^2 of columns lane + 32 t
#pragma unroll
  for (int t = 0; t < CN; ++t) cn[t] = 0.f;
  float xn = 0.f;  // |x|^2 of row lane (lane < TM)

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks)
      load_chunk<TM, TN, kVec>(smem + s * T::kStageFloats, x, c, n0, k0, N, K, F, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch landed; the stage refilled below was read at ch - 1
    const int next = ch + kStages - 1;
    if (next < chunks)
      load_chunk<TM, TN, kVec>(smem + (next % kStages) * T::kStageFloats, x, c, n0, k0, N,
                               K, F, next);
    cp_async_commit();

    const float* xs = smem + (ch % kStages) * T::kStageFloats;
    const float* cs = xs + TM * kPitch;
#pragma unroll
    for (int q = 0; q < kWarpF / 4; ++q) {
      const int f = warp * kWarpF + q * 4;
      float4 a[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (rg + 4 * i) * kPitch + f);
      // one center column at a time, a component at a time down the rows:
      // consecutive FMAs are independent, and each output still adds its
      // features in ascending order
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(cs + (cg + 8 * j) * kPitch + f);
#pragma unroll
        for (int i = 0; i < RI; ++i) prod[i][j] = fmaf(a[i].x, b.x, prod[i][j]);
#pragma unroll
        for (int i = 0; i < RI; ++i) prod[i][j] = fmaf(a[i].y, b.y, prod[i][j]);
#pragma unroll
        for (int i = 0; i < RI; ++i) prod[i][j] = fmaf(a[i].z, b.z, prod[i][j]);
#pragma unroll
        for (int i = 0; i < RI; ++i) prod[i][j] = fmaf(a[i].w, b.w, prod[i][j]);
      }
#pragma unroll
      for (int u = 0; u < CN; ++u)
        cn[u] = sq4(*reinterpret_cast<const float4*>(cs + (lane + 32 * u) * kPitch + f), cn[u]);
      if (lane < TM) xn = sq4(*reinterpret_cast<const float4*>(xs + lane * kPitch + f), xn);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them for the partials

  float* part = smem;                        // [warp][row][col]
  float* norms = smem + kWarps * TM * TN;    // [warp][rows, then cols]
  float* nsum = norms + kWarps * T::kVecs;   // [rows, then cols], summed in warp order
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      part[(warp * TM + rg + 4 * i) * TN + cg + 8 * j] = prod[i][j];
#pragma unroll
  for (int u = 0; u < CN; ++u) norms[warp * T::kVecs + TM + lane + 32 * u] = cn[u];
  if (lane < TM) norms[warp * T::kVecs + lane] = xn;
  __syncthreads();
  for (int v = threadIdx.x; v < T::kVecs; v += kThreads) {
    float s = norms[v];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += norms[w * T::kVecs + v];
    nsum[v] = s;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < TM * TN; o += kThreads) {
    const int r = o / TN, k = o - r * TN;
    const int n = n0 + r, kk = k0 + k;
    if (n >= N || kk >= K) continue;
    float p = part[o];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) p += part[w * TM * TN + o];
    const float d = (nsum[r] + nsum[TM + k]) - 2.f * p;
    out[(size_t)n * K + kk] = d < 0.f ? 0.f : d;
  }
}

template <int TM, int TN>
int launch(const float* x, const float* c, float* out, int N, int K, int F,
           cudaStream_t stream) {
  const size_t smem = Tile<TM, TN>::kSmem;
  dim3 grid((K + TN - 1) / TN, (N + TM - 1) / TM);
  const bool vec = F % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0 &&
                   (reinterpret_cast<size_t>(c) & 15) == 0;
  static bool raised[2] = {false, false};  // the shared-memory limit, once a kernel
  if (!raised[vec]) {
    cudaFuncSetAttribute(vec ? pdist_kernel<TM, TN, true> : pdist_kernel<TM, TN, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    raised[vec] = true;
  }
  if (vec)
    pdist_kernel<TM, TN, true><<<grid, kThreads, smem, stream>>>(x, c, out, N, K, F);
  else
    pdist_kernel<TM, TN, false><<<grid, kThreads, smem, stream>>>(x, c, out, N, K, F);
  return (int)cudaGetLastError();
}

int blocks(int N, int K, int tm, int tn) { return ((N + tm - 1) / tm) * ((K + tn - 1) / tn); }

}  // namespace

extern "C" {

int repro_pdist_sq(const float* x, const float* c, float* out, int N, int K, int F,
                   void* stream) {
  if (N < 0 || K < 0 || F < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || K == 0) return (int)cudaGetLastError();
  // the largest tile that still gives about one block an SM (132 SMs)
  constexpr int kWave = 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks(N, K, 32, 64) >= kWave) return launch<32, 64>(x, c, out, N, K, F, s);
  if (blocks(N, K, 32, 32) >= kWave) return launch<32, 32>(x, c, out, N, K, F, s);
  return launch<16, 32>(x, c, out, N, K, F, s);
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
