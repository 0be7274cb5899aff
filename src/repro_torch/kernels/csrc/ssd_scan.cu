// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), as four kernels
// launched back to back on one stream. Replaces the Pallas TPU kernel
// `_kernel` of src/repro/kernels/ssd_scan.py.
//
// Layout (as in the TPU kernel), all f32 and contiguous: x [b, S, H, P],
// dt [b, S, H], A [H], B/C [b, S, N] (one group: shared by the heads);
// outputs y [b, S, H, P] and the final state [b, H, P, N]. `cl` (the
// chunk) divides S and is at most 128; nc = S / cl. Inside a chunk, with
// cum the in-chunk prefix sum of dt * A (per head):
//   L[i, j]  = exp(cum[i] - cum[j]) for j <= i, else 0
//   y        = (C B^T o L) (x dt) + (C exp(cum)) S_prev^T
//   S_next   = exp(cum[-1]) S_prev + (x dt exp(cum[-1] - cum))^T B
// The segment sums are masked BEFORE the exp: the upper triangle's
// cum[i] - cum[j] is positive and could overflow to inf, and masking
// after the exp would give inf * 0 = NaN.
//
// What bounds it on this card: operations (~4.1 GFLOP against ~58 MB at
// b 4, S 1024, H 24, P 64, N 128, cl 128). The products run as f32 FMAs
// on the CUDA cores: the 2e-4 tolerance rules out plain TF32.
//
// The TPU kernel walks the chunks in order per (b, h), carrying the
// state. Here only the carry itself is sequential; the heavy work runs
// in parallel over every chunk:
//   1. ssd_cb, per (b, chunk, 64 x 64 quadrant of the lower triangle):
//      C B^T, once for all heads (written transposed, Gt[j][i]).
//   2. ssd_chunk_state, per (b, chunk, h): cum for its head by one warp
//      scan (4 steps per lane, then shuffles; stored for passes 3 and
//      4), then the chunk's own state contribution
//      (x dt exp(cum[-1] - cum))^T B [P, N].
//   3. ssd_state_pass, per (b, h, 1024 of the P N elements): the carry
//      S_c = exp(cum_c[-1]) S_{c-1} + local_c over the chunks. It
//      overwrites local_c with the state entering chunk c (in place:
//      [b, nc, H, P, N] f32, 25 MB at the model's shapes, inside the 50
//      MB L2) and writes the final state.
//   4. ssd_chunk_out, per (b, chunk, h): y = (Gt^T o L)(x dt) + (C
//      exp(cum)) S_{c-1}^T, two products of depth cl and N into one
//      accumulator.
// At the model's shapes that is 96 + 768 + 768 + 768 CTAs; the old
// single kernel had 384 and recomputed C B^T 96 times per (b, chunk).
//
// Products 1, 2 and 4 share one register tiling: a CTA computes a
// [128 x 64] (pass 1: [64 x 64]) output tile, each thread an 8 x 8
// block of it, over k-slices of 32 in shared memory; per k a thread
// loads 2 + 2 float4 and does 64 FMAs (16 FMAs per shared-memory load).
// Each k-slice is copied by cp.async, as it lies in device memory
// (16-byte copies where P, N and cl are multiples of 4 and the bases are
// 16-byte aligned, else 4-byte ones), into a raw slice in shared memory;
// the copies of slice t + 1 are in flight while the FMAs of slice t
// run. The elementwise factors (dt, the decays, the causal mask) and the
// transposition of operands that are contiguous along k in device
// memory (C, B and S_{c-1} where k runs over N) cannot ride on a copy:
// once its copies have landed, each thread applies them to the raw
// elements it fetched as it writes them into the slice the FMAs read.
// Passes 2 and 4 take 56 KB of (dynamic) shared memory a CTA. Pass 4
// skips the rows that the causal mask zeroes in its slices past depth
// 64.
//
// The entry point returns the first launch error (cudaGetLastError()).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kKS = 32;          // k-slice depth

// acc[r][c] += sum_k As[k][m_r] Bs[k][n_c] over one k-slice, with
// m_r = 4 tm + r (r < 4) or MH + 4 tm + r - 4, n_c likewise with NH.
// kLowerOnly skips rows r < 4 (all zero in the slice).
template <int MH, int NH, bool kLowerOnly = false>
__device__ __forceinline__ void fma_slice(const float* As, const float* Bs,
                                          int tm, int tn,
                                          float (&acc)[8][8]) {
  constexpr int lda = 2 * MH + 4, ldb = 2 * NH + 4;
#pragma unroll 4
  for (int k = 0; k < kKS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * lda + 4 * tm);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * lda + MH + 4 * tm);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * ldb + 4 * tn);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * ldb + NH + 4 * tn);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = kLowerOnly ? 4 : 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
  }
}

__device__ __forceinline__ int tile_idx(int t, int half, int j) {
  return j < 4 ? 4 * t + j : half + 4 * t + j - 4;
}

// cp.async: a copy from device to shared memory that bypasses the
// registers and runs while the thread goes on; cp.async.wait_all waits
// for this thread's copies, whose results it then sees (other threads
// see them after a barrier).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Raw slices: an operand's k-slice [kKS x M] as it lies in device
// memory, [k][m] (row stride M + 4) where it is contiguous along m, and
// [m][k] (row stride kKS + 4) where it is contiguous along k (kCols).
template <int M>
constexpr int kRaw = (M + 4) * (kKS + 4);

// Slot u of the thread in a raw slice: (k, m) and the kW elements from
// it along the contiguous dimension. kW = 4 (16-byte copies) where every
// extent, row stride and base is a multiple of 4 floats (kVec), else 1.
template <int M, int NT, bool kCols, bool kVec>
struct Slots {
  static constexpr int kW = kVec ? 4 : 1;
  static constexpr int kPer = kKS * M / (NT * kW);
  // Fully unrolled, the 4-byte form's 32 slots per operand would keep 32
  // addresses live across the FMAs (ptxas spilled at 255 registers).
  static constexpr int kUnroll = kW == 4 ? kPer : 4;
  static __device__ __forceinline__ int at(int u, int& k, int& m) {
    const int e = threadIdx.x + NT * u;
    k = kCols ? (e % (kKS / kW)) * kW : e / (M / kW);
    m = kCols ? e / (kKS / kW) : (e % (M / kW)) * kW;
    return kCols ? m * (kKS + 4) + k : k * (M + 4) + m;
  }
};

// Start the copies of one operand's k-slice into its raw slice: cp.async
// for the elements in range, zeros stored for the rest. Op: in(k, m)
// (range only), at(k, m) (its address) and apply(k, m, v), k the
// absolute depth index.
template <int M, int NT, bool kCols, bool kVec, class Op>
__device__ __forceinline__ void fetch(const Op& op, int k0, float* raw) {
  using Sl = Slots<M, NT, kCols, kVec>;
#pragma unroll(Sl::kUnroll)
  for (int u = 0; u < Sl::kPer; ++u) {
    int k, m;
    float* d = raw + Sl::at(u, k, m);
    const bool in = op.in(k0 + k, m);
    if (Sl::kW == 4) {
      if (in)
        cp_async16(d, op.at(k0 + k, m));
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (in)
        cp_async4(d, op.at(k0 + k, m));
      else
        *d = 0.f;
    }
  }
}

// Once the thread's copies have landed: dst[k][m] (row stride M + 4) =
// op.apply of the raw elements it fetched (its own, so no barrier comes
// between), transposed where the raw slice is [m][k].
template <int M, int NT, bool kCols, bool kVec, class Op>
__device__ __forceinline__ void finish(const Op& op, int k0, const float* raw,
                                       float* dst) {
  using Sl = Slots<M, NT, kCols, kVec>;
#pragma unroll(Sl::kUnroll)
  for (int u = 0; u < Sl::kPer; ++u) {
    int k, m;
    const float* r = raw + Sl::at(u, k, m);
    float v[4];
    if (Sl::kW == 4) {
      const float4 f = *reinterpret_cast<const float4*>(r);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = *r;
    }
#pragma unroll
    for (int q = 0; q < Sl::kW; ++q) {
      const int kq = kCols ? k + q : k, mq = kCols ? m : m + q;
      dst[kq * (M + 4) + mq] = op.apply(k0 + kq, mq, v[q]);
    }
  }
}

// Floats of shared memory gemm<MH, NH, ...> takes: a k-slice of each
// operand, laid out for the FMAs, and a raw slice of each.
template <int MH, int NH>
constexpr int kGemmSmem =
    kKS * (2 * MH + 4 + 2 * NH + 4) + kRaw<2 * MH> + kRaw<2 * NH>;
// Dynamic shared memory of passes 2 and 4 (bytes; above the 48 KB of
// static shared memory): gemm's plus the per-row factors.
constexpr int kStateSmem = 4 * (kGemmSmem<64, 32> + 128);
constexpr int kOutSmem = 4 * (kGemmSmem<64, 32> + 3 * 128);

// acc += A^T B over depth [0, depth) in k-slices, A [depth x 2 MH] and
// B [depth x 2 NH], in the kGemmSmem<MH, NH> floats at sm. The copies of
// slice t + 1 into the raw slices run while the FMAs of slice t do; then
// a barrier (every thread is done with slice t), each thread turns the
// raw elements it fetched into slice t + 1 (elementwise factors,
// transposition), and a barrier publishes it. kTri: A is lower
// triangular (A[k][m] = 0 for m < k), so rows m < MH of the slices at
// depth >= MH are zero and skipped.
template <int MH, int NH, int NT, bool kColsA, bool kColsB, bool kTri,
          bool kVec, class OpA, class OpB>
__device__ __forceinline__ void gemm(const OpA& opa, const OpB& opb,
                                     int depth, float* sm, int tm, int tn,
                                     float (&acc)[8][8]) {
  constexpr int MA = 2 * MH, MB = 2 * NH;
  float* As = sm;
  float* Bs = As + kKS * (MA + 4);
  float* Ra = Bs + kKS * (MB + 4);
  float* Rb = Ra + kRaw<MA>;
  fetch<MA, NT, kColsA, kVec>(opa, 0, Ra);
  fetch<MB, NT, kColsB, kVec>(opb, 0, Rb);
  cp_async_wait_all();
  finish<MA, NT, kColsA, kVec>(opa, 0, Ra, As);
  finish<MB, NT, kColsB, kVec>(opb, 0, Rb, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < depth; k0 += kKS) {
    const int k1 = k0 + kKS;
    if (k1 < depth) {
      fetch<MA, NT, kColsA, kVec>(opa, k1, Ra);
      fetch<MB, NT, kColsB, kVec>(opb, k1, Rb);
    }
    if (kTri && k0 >= MH)
      fma_slice<MH, NH, true>(As, Bs, tm, tn, acc);
    else
      fma_slice<MH, NH>(As, Bs, tm, tn, acc);
    __syncthreads();
    if (k1 < depth) {
      cp_async_wait_all();
      finish<MA, NT, kColsA, kVec>(opa, k1, Ra, As);
      finish<MB, NT, kColsB, kVec>(opb, k1, Rb, Bs);
      __syncthreads();
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
}

// Element (k, m) of a row-major [rows, ld] matrix slice: src[(row0 + m)
// * ld + col0 + k] (kByRow: m is the row) or src[(row0 + k) * ld + col0
// + m]; in range for rows < `rows` and col0 + column < `cols`.
template <bool kByRow>
struct Tile {
  const float* src;
  int64_t row0;
  int ld, col0, rows, cols;
  __device__ __forceinline__ bool in(int k, int m) const {
    return (kByRow ? m : k) < rows && col0 + (kByRow ? k : m) < cols;
  }
  __device__ __forceinline__ const float* at(int k, int m) const {
    return src + (row0 + (kByRow ? m : k)) * ld + col0 + (kByRow ? k : m);
  }
  __device__ __forceinline__ float apply(int, int, float v) const {
    return v;
  }
};

// ---- pass 1: Gt[b, c][j][i] = C_i . B_j for i >= j, by 64 x 64
// quadrant (the one above the diagonal is all zero and is skipped).
template <bool kVec>
__global__ void __launch_bounds__(64)
ssd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
       float* __restrict__ gt, int S, int N, int cl) {
  // A [n][j] = B[j][n], B [n][i] = C[i][n].
  __shared__ __align__(16) float sm[kGemmSmem<32, 32>];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int jb = blockIdx.z == 2 ? 64 : 0, ib = blockIdx.z == 0 ? 0 : 64;
  if (jb >= cl || ib >= cl) return;
  const int64_t row0 = static_cast<int64_t>(b) * S + c * cl;
  const int tid = threadIdx.x, tm = tid % 8, tn = tid / 8;
  float acc[8][8];
  zero(acc);
  gemm<32, 32, 64, true, true, false, kVec>(
      Tile<true>{Bm, row0 + jb, N, 0, cl - jb, N},
      Tile<true>{Cm, row0 + ib, N, 0, cl - ib, N}, N, sm, tm, tn, acc);
  float* g = gt + (static_cast<int64_t>(b) * nc + c) * cl * cl;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = jb + tile_idx(tm, 32, r);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = ib + tile_idx(tn, 32, q);
      if (j < cl && i < cl && i >= j) g[j * cl + i] = acc[r][q];
    }
  }
}

// x[j][p] dt[j] w[j] for the chunk's rows j and one head.
struct XdtW {
  const float* x;
  const float* w;               // [cl] in shared memory
  int64_t row0;
  int H, h, P, p0, cl;
  __device__ __forceinline__ bool in(int k, int m) const {
    return k < cl && p0 + m < P;
  }
  __device__ __forceinline__ const float* at(int k, int m) const {
    return x + ((row0 + k) * H + h) * P + p0 + m;
  }
  __device__ __forceinline__ float apply(int k, int, float v) const {
    return k < cl ? v * w[k] : 0.f;
  }
};

// ---- pass 2: cum for one head (one warp scan), then the chunk's own
// state contribution buf[b, c, h][p][n] = sum_j (x dt e^{cum[-1] -
// cum})[j][p] B[j][n].
template <bool kVec>
__global__ void __launch_bounds__(128)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ cum, float* __restrict__ buf, int S,
                int H, int P, int N, int cl) {
  // gemm's (A [j][n] = B[j][n], B [j][p]), then w [cl].
  extern __shared__ __align__(16) float smem[];   // kStateSmem bytes
  float* w = smem + kGemmSmem<64, 32>;
  const int nc = S / cl;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc % nc;
  const int n0 = blockIdx.y * 128, p0 = blockIdx.z * 64;
  const int64_t row0 = static_cast<int64_t>(b) * S + c * cl;
  const int64_t bch = static_cast<int64_t>(bc) * H + h;
  const int tid = threadIdx.x, tm = tid % 16, tn = tid / 16;
  if (tid < 32) {
    // In-chunk prefix sum of dt A: lane owns steps 4 lane .. 4 lane + 3.
    const float a = A[h];
    float v[4], run = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * tid + u;
      run += j < cl ? dt[(row0 + j) * H + h] * a : 0.f;
      v[u] = run;
    }
    float scan = run;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, scan, d);
      if (tid >= d) scan += up;
    }
    const float total = __shfl_sync(0xffffffffu, scan, 31);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * tid + u;
      if (j < cl) {
        const float cj = scan - run + v[u];
        w[j] = dt[(row0 + j) * H + h] * expf(total - cj);
        if (blockIdx.y == 0 && blockIdx.z == 0) cum[bch * cl + j] = cj;
      }
    }
  }
  __syncthreads();
  float acc[8][8];
  zero(acc);
  gemm<64, 32, 128, false, false, false, kVec>(
      Tile<false>{Bm, row0, N, n0, cl, N},
      XdtW{x, w, row0, H, h, P, p0, cl}, cl, smem, tm, tn, acc);
  float* out = buf + bch * P * N;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = p0 + tile_idx(tn, 32, q);
    if (p >= P) continue;
#pragma unroll
    for (int r = 0; r < 8; r += 4) {
      const int n = n0 + tile_idx(tm, 64, r);
      float* dst = out + static_cast<int64_t>(p) * N + n;
      if (N % 4 == 0 && n + 3 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[r][q], acc[r + 1][q], acc[r + 2][q], acc[r + 3][q]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n + u < N) dst[u] = acc[r + u][q];
      }
    }
  }
}

// ---- pass 3: the carry over the chunks, in place in buf; each thread
// fetches a group of 8 chunks' values before it walks them.
__global__ void __launch_bounds__(256)
ssd_state_pass(const float* __restrict__ cum, float* __restrict__ buf,
               float* __restrict__ state, int H, int PN, int cl, int nc) {
  constexpr int kG = 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int e0 = blockIdx.x * 1024 + threadIdx.x;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += kG) {
    float v[kG][4], decay[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int64_t bch = (static_cast<int64_t>(b) * nc + c0 + g) * H + h;
      const bool in = c0 + g < nc;
      decay[g] = in ? expf(cum[bch * cl + cl - 1]) : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 256 * u;
        v[g][u] = in && e < PN ? buf[bch * PN + e] : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (c0 + g >= nc) break;
      const int64_t bch = (static_cast<int64_t>(b) * nc + c0 + g) * H + h;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 256 * u;
        if (e < PN) {
          buf[bch * PN + e] = s[u];          // the state entering the chunk
          s[u] = decay[g] * s[u] + v[g][u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = e0 + 256 * u;
    if (e < PN) state[static_cast<int64_t>(bh) * PN + e] = s[u];
  }
}

// (Gt^T o L)[j][i] = Gt[j][i] e^{cum[i] - cum[j]} for i >= j, else 0:
// the mask comes before the exp.
struct MaskedCB {
  const float* g;
  const float* cs;              // [cl] in shared memory
  int cl;
  __device__ __forceinline__ bool in(int k, int m) const {
    return m < cl && k < cl;    // the upper triangle is never written
  }
  __device__ __forceinline__ const float* at(int k, int m) const {
    return g + k * cl + m;
  }
  __device__ __forceinline__ float apply(int k, int m, float v) const {
    return m < cl && k < cl && m >= k ? v * expf(cs[m] - cs[k]) : 0.f;
  }
};

// C[i][n] e^{cum[i]}, transposed while staged.
struct CDecay {
  const float* C;
  const float* ecs;             // [cl] in shared memory
  int64_t row0;
  int N, cl;
  __device__ __forceinline__ bool in(int k, int m) const {
    return m < cl && k < N;
  }
  __device__ __forceinline__ const float* at(int k, int m) const {
    return C + (row0 + m) * N + k;
  }
  __device__ __forceinline__ float apply(int, int m, float v) const {
    return m < cl ? v * ecs[m] : 0.f;
  }
};

// ---- pass 4: y = (Gt^T o L)(x dt) + (C e^cum) S_prev^T. The 16-byte
// copy variant is capped at 168 registers so that 3 CTAs (and their
// 3 x 56 KB of shared memory) fit on an SM; on the H100 it ran faster
// so than at 2 CTAs, despite a few bytes of spill.
template <bool kVec>
__global__ void __launch_bounds__(128, kVec ? 3 : 1)
ssd_chunk_out(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Cm, const float* __restrict__ gt,
              const float* __restrict__ cum, const float* __restrict__ buf,
              float* __restrict__ y, int S, int H, int P, int N, int cl) {
  // gemm's (A [k][i], B [k][p]), then cs, ecs, dts [cl] each.
  extern __shared__ __align__(16) float smem[];   // kOutSmem bytes
  float* cs = smem + kGemmSmem<64, 32>;
  float* ecs = cs + 128;
  float* dts = ecs + 128;
  const int nc = S / cl;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc % nc;
  const int p0 = blockIdx.y * 64;
  const int64_t row0 = static_cast<int64_t>(b) * S + c * cl;
  const int64_t bch = static_cast<int64_t>(bc) * H + h;
  const int tid = threadIdx.x, tm = tid % 16, tn = tid / 16;
  for (int j = tid; j < cl; j += 128) {
    cs[j] = cum[bch * cl + j];
    ecs[j] = expf(cs[j]);
    dts[j] = dt[(row0 + j) * H + h];
  }
  __syncthreads();
  float acc[8][8];
  zero(acc);
  // Depth cl: the masked C B^T against x dt (rows i < 64 of the slices
  // at j >= 64 are zero and skipped).
  gemm<64, 32, 128, false, false, true, kVec>(
      MaskedCB{gt + static_cast<int64_t>(bc) * cl * cl, cs, cl},
      XdtW{x, dts, row0, H, h, P, p0, cl}, cl, smem, tm, tn, acc);
  // Depth N: C e^cum against the state entering the chunk.
  gemm<64, 32, 128, true, true, false, kVec>(
      CDecay{Cm, ecs, row0, N, cl},
      Tile<true>{buf + bch * P * N, p0, N, 0, P - p0, N}, N, smem, tm, tn,
      acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = tile_idx(tm, 64, r);
    if (i >= cl) continue;
    float* dst = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      const int p = p0 + tile_idx(tn, 32, q);
      if (P % 4 == 0 && p + 3 < P) {
        *reinterpret_cast<float4*>(dst + p) = make_float4(
            acc[r][q], acc[r][q + 1], acc[r][q + 2], acc[r][q + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (p + u < P) dst[p + u] = acc[r][q + u];
      }
    }
  }
}

}  // namespace

// Scratch (allocated by the caller): gt [b, nc, cl, cl], cum [b, nc, H,
// cl], buf [b, nc, H, P, N], all f32. Launches four kernels on `stream`.
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A, const float* B,
                               const float* C, float* y, float* state,
                               float* gt, float* cum, float* buf, int b,
                               int S, int H, int P, int N, int chunk,
                               void* stream) {
  if (b == 0 || H == 0 || P == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || chunk > 128 || S % chunk != 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk, pt = (P + 63) / 64, nt = (N + 127) / 128;
  // 16-byte copies where every extent, row stride and base allows them.
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = P % 4 == 0 && N % 4 == 0 && chunk % 4 == 0 && al16(x) &&
                   al16(B) && al16(C);
  (vec ? ssd_cb<true> : ssd_cb<false>)<<<dim3(nc, b, 3), 64, 0, s>>>(
      B, C, gt, S, N, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto state_k = vec ? ssd_chunk_state<true> : ssd_chunk_state<false>;
  e = cudaFuncSetAttribute(state_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStateSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  state_k<<<dim3(b * nc * H, nt, pt), 128, kStateSmem, s>>>(
      x, dt, A, B, cum, buf, S, H, P, N, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_pass<<<dim3((P * N + 1023) / 1024, b * H), 256, 0, s>>>(
      cum, buf, state, H, P * N, chunk, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto out_k = vec ? ssd_chunk_out<true> : ssd_chunk_out<false>;
  e = cudaFuncSetAttribute(out_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kOutSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out_k<<<dim3(b * nc * H, pt), 128, kOutSmem, s>>>(x, dt, C, gt, cum, buf,
                                                     y, S, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
