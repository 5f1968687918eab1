// Pairwise squared distances of the KMeans assignment step:
//
//   repro_pdist_sq  replaces src/repro/kernels/pdist.py::pdist_sq
//                   (pl.pallas_call at pdist.py:53):
//                   out[n, k] = max(|x_n|^2 + |c_k|^2 - 2 x_n . c_k, 0).
//
// Bound on H100: at the KMeans shapes (N <= 1024 candidates, K <= 256
// centers, F ~ 500 features) the 2*N*K*F multiply-adds in f32 outside the
// tensor cores (67 TFLOP/s) take longer than moving the N*F + K*F inputs
// and the N*K output, so it is bound by operations.  The reference runs
// the product in IEEE f32; this kernel does too (no TF32, no cuBLAS).
//
// Design.  A classic shared-memory tiled product: one block per 32 x 32
// output tile, 32 x 8 threads, each thread owns one center column and
// four point rows.  F is walked in 32-wide slices staged in shared memory
// (rows padded to 33 floats: no bank conflicts).  Every thread adds its
// x.c, |x|^2 and |c|^2 terms in ascending feature order, so the result is
// the same on every run.  NaN propagates through the clamp, as
// jnp.maximum does.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;

__global__ void __launch_bounds__(kTile * kThreadsY)
pdist_kernel(const float* __restrict__ x, const float* __restrict__ c, float* __restrict__ out,
             int N, int K, int F) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float cs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;
  float prod[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float xx[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float cc = 0.f;
  for (int f0 = 0; f0 < F; f0 += kTile) {
    // stage x[n0:n0+32, f0:f0+32] and c[k0:k0+32, f0:f0+32] (zeros past the edges)
    for (int r = ty; r < kTile; r += kThreadsY) {
      const int n = n0 + r, k = k0 + r, f = f0 + tx;
      xs[r][tx] = (n < N && f < F) ? x[(size_t)n * F + f] : 0.f;
      cs[r][tx] = (k < K && f < F) ? c[(size_t)k * F + f] : 0.f;
    }
    __syncthreads();
    const int width = min(kTile, F - f0);
    for (int j = 0; j < width; ++j) {
      const float cv = cs[tx][j];
      cc += cv * cv;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float xv = xs[ty + i * kThreadsY][j];
        prod[i] += xv * cv;
        xx[i] += xv * xv;
      }
    }
    __syncthreads();
  }
  const int k = k0 + tx;
  if (k >= K) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int n = n0 + ty + i * kThreadsY;
    if (n < N) {
      const float d = (xx[i] + cc) - 2.f * prod[i];
      out[(size_t)n * K + k] = d < 0.f ? 0.f : d;
    }
  }
}

}  // namespace

extern "C" {

int repro_pdist_sq(const float* x, const float* c, float* out, int N, int K, int F,
                   void* stream) {
  if (N < 0 || K < 0 || F < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || K == 0) return (int)cudaGetLastError();
  dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  dim3 block(kTile, kThreadsY);
  pdist_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, c, out, N, K, F);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
