// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a). Replaces the
// Pallas TPU kernel `_kernel` of src/repro/kernels/ssd_scan.py.
//
// Layout (as in the TPU kernel), all f32 and contiguous: x [b, S, H, P],
// dt [b, S, H], A [H], B/C [b, S, N]; outputs y [b, S, H, P] and the
// final state [b, H, P, N]. `chunk` divides S and is at most 128.
//
// Per (b, h) the chunks run in order with a [P, N] state carry; inside a
// chunk of length cl, with cum the in-chunk prefix sum of dt * A:
//   L[i, j]  = exp(cum[i] - cum[j]) for j <= i, else 0
//   y        = (C B^T o L) (x dt) + (C exp(cum)) state^T
//   state'   = exp(cum[-1]) state + (x dt exp(cum[-1] - cum))^T B
// The segment sums are masked BEFORE the exp: the upper triangle's
// cum[i] - cum[j] is positive and could overflow to inf, and masking
// after the exp would give inf * 0 = NaN.
//
// What bounds it on this card: operations (~4 GFLOP against ~58 MB at
// b 4, S 1024, H 24, P 64, N 128). This first version is the simple
// one: f32 FMAs on CUDA cores, no tensor cores and no TF32 (whose 10-bit
// mantissa would miss the 2e-4 tolerance); `wgmma` is later work.
//
// Design: the TPU kernel's sequential chunk axis becomes a loop inside
// one CTA, which keeps the state in shared memory. The P rows of the
// state evolve independently, so each CTA owns one (b, h, tile of PT
// state rows): 4x more CTAs than (b, h) alone at P 64 (PT 16), at the
// price of recomputing C B^T o L per P tile. Per chunk a CTA stages B
// and C ([cl, N] each, 64 KB at N 128), builds the lower triangle of
// C B^T o L in shared memory, then computes y and the new state for its
// rows; rows are padded by one float so strided reads hit distinct
// banks. ~212 KB of dynamic shared memory at cl = N = 128 (opt-in above
// 48 KB). The state is written once, after the last chunk.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

size_t smem_floats(int cl, int N, int PT) {
  // Bs, Cs [cl][N+1]; Gs [cl][cl+1]; xdt [cl][PT]; st [PT][N+1];
  // cum, dts, ecum, dend [cl].
  return 2 * static_cast<size_t>(cl) * (N + 1)
         + static_cast<size_t>(cl) * (cl + 1) + static_cast<size_t>(cl) * PT
         + static_cast<size_t>(PT) * (N + 1) + 4 * static_cast<size_t>(cl);
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int P, int N,
           int cl, int PT) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldg = cl + 1;
  float* Bs = smem;
  float* Cs = Bs + cl * ldn;
  float* Gs = Cs + cl * ldn;
  float* xdt = Gs + cl * ldg;
  float* st = xdt + cl * PT;
  float* cum = st + PT * ldn;
  float* dts = cum + cl;
  float* ecum = dts + cl;
  float* dend = ecum + cl;

  const int b = blockIdx.z, h = blockIdx.y, p0 = blockIdx.x * PT;
  const int tid = threadIdx.x;
  const float Ah = A[h];
  for (int e = tid; e < PT * N; e += kThreads) st[(e / N) * ldn + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += cl) {
    const int64_t row0 = static_cast<int64_t>(b) * S + c0;   // (b, s) row
    for (int e = tid; e < cl * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const int64_t at = (row0 + j) * N + n;
      Bs[j * ldn + n] = Bm[at];
      Cs[j * ldn + n] = Cm[at];
    }
    for (int j = tid; j < cl; j += kThreads) dts[j] = dt[(row0 + j) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int j = 0; j < cl; ++j) {
        run += dts[j] * Ah;
        cum[j] = run;
      }
    }
    __syncthreads();
    const float total = cum[cl - 1];
    for (int j = tid; j < cl; j += kThreads) {
      ecum[j] = expf(cum[j]);
      dend[j] = expf(total - cum[j]);
    }
    for (int e = tid; e < cl * PT; e += kThreads) {
      const int j = e / PT, p = e % PT;
      xdt[j * PT + p] = x[((row0 + j) * H + h) * P + p0 + p] * dts[j];
    }
    // Lower triangle of (C B^T) o L.
    for (int e = tid; e < cl * cl; e += kThreads) {
      const int i = e / cl, j = e % cl;
      if (j > i) continue;
      float acc = 0.f;
      for (int n = 0; n < N; ++n)
        acc = fmaf(Cs[i * ldn + n], Bs[j * ldn + n], acc);
      Gs[i * ldg + j] = acc * expf(cum[i] - cum[j]);
    }
    __syncthreads();
    // y = G (x dt) + (C exp(cum)) state^T, with the state before this chunk.
    for (int e = tid; e < cl * PT; e += kThreads) {
      const int i = e / PT, p = e % PT;
      float yd = 0.f;
      for (int j = 0; j <= i; ++j)
        yd = fmaf(Gs[i * ldg + j], xdt[j * PT + p], yd);
      float yo = 0.f;
      const float ec = ecum[i];
      for (int n = 0; n < N; ++n)
        yo = fmaf(Cs[i * ldn + n] * ec, st[p * ldn + n], yo);
      y[((row0 + i) * H + h) * P + p0 + p] = yd + yo;
    }
    __syncthreads();
    // state' = exp(cum[-1]) state + (x dt decay_end)^T B
    const float etot = expf(total);
    for (int e = tid; e < PT * N; e += kThreads) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < cl; ++j)
        acc = fmaf(xdt[j * PT + p] * dend[j], Bs[j * ldn + n], acc);
      st[p * ldn + n] = etot * st[p * ldn + n] + acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < PT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    state_out[((static_cast<int64_t>(b) * H + h) * P + p0 + p) * N + n] =
        st[p * ldn + n];
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A, const float* B,
                               const float* C, float* y, float* state,
                               int b, int S, int H, int P, int N, int chunk,
                               void* stream) {
  if (b == 0 || H == 0 || P == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || chunk > 128 || S % chunk != 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int PT = 16;                       // state rows per CTA: a divisor of P
  while (P % PT) PT /= 2;
  const size_t smem = sizeof(float) * smem_floats(chunk, N, PT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(P / PT, H, b);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, B, C, y, state, S, H, P, N, chunk, PT);
  return static_cast<int>(cudaGetLastError());
}
