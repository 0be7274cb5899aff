// Flash attention (GQA, causal, optional sliding window) on Hopper's CUDA
// cores (sm_90a), in f32. Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (via `flash_attention`) for f32
// inputs, and for the bf16 shapes that flash_attention_wgmma.cu does not
// take (head_dim not a multiple of 16 or past 192, or no key).
//
// Layout (as in the TPU kernel): q [B, Sq, H, dh], k/v [B, Skv, KV, dh],
// f32 or bf16, contiguous; the output has q's shape and dtype. Query
// head h reads KV head h / (H / KV). Any Sq and Skv; 1 <= dh <= 256.
//
// What bounds it on this card: operations. The two products do ~S/4
// operations per byte of q/k/v/o at S 1024, and they stay on f32 FMAs
// (TF32's 10-bit mantissa would miss the f32 tolerance of 2e-5), so the
// bound is the CUDA cores' 67 TFLOP/s (cuBLAS's f32 GEMM reaches ~75% of
// it on an H100). On the way there the limits are shared memory,
// registers and occupancy. Counted as one cycle of the SM's
// shared-memory pipe per warp-wide 4 bytes loaded, against four
// warp-wide FMAs a cycle, a thread that holds an R x C tile of a product
// (R C FMAs per R + C floats loaded) keeps the FMAs at most two thirds
// busy with 8 x 4, fully with 8 x 8. (On the card 8 x 8 ran only 4%
// faster than 8 x 4 in the same form, so latency at 8 warps per SM is
// the larger part of what is left.)
//
// What the design does about it:
// - Register tiles. One CTA per (b, h, 128-row q tile), kv tiles of 64
//   keys. For dh <= 64 a thread owns an 8 x 8 tile of the 128 x 64
//   scores (rows rg + 16 i, keys cg + 8 j; 128 threads) and the same 8
//   rows x dh/8 columns of O, so m, l and the rescale stay in its
//   registers. dh 128 takes 8 x 4 tiles (256 threads), which keeps its O
//   tile at 64 registers. A row group's threads are lanes of one warp: a
//   row max or sum is 3 (or 4) shuffles, and P is shared through shared
//   memory between those lanes only (__syncwarp, no barrier).
// - The large bucket, 128 < dh <= 256 (DeepSeek-V3's MLA prefill in f32,
//   its teacher-forced check, runs dh 192 = 128 + 64 here; in bf16 it
//   takes the tensor-core kernel). A 128-row Q tile there would need 128
//   x 260 x 4 of Q plus 2 x 64 x 260 x 4 of K and V, over the 227 KB a
//   CTA may have, and an 8 x 8 O tile of 256 columns is 256 registers.
//   So this bucket takes 64-row Q tiles, 8 row groups of 32 lanes (256
//   threads, one warp per row group): each thread holds 8 rows x 2 keys
//   of S and 8 rows x 8 columns of O (64 registers), and a CTA 219 KB of
//   shared memory (one per SM). Fewer FMAs per operand loaded than the
//   smaller buckets: a simple form, not a fast one (f32, and bf16 past dh
//   192, only).
// - Vector operands, no bank conflicts. Q [128][DB + 4] and K, V
//   [64][DB + 4] (DB the dh bucket, 32, 64 or 128; (DB + 4) / 4 is odd,
//   so 8 consecutive rows fall on 8 distinct 16-byte bank groups; the
//   pad columns are zeros) are row-major. Each step over 4 of dh reads 8
//   float4 of q and 8 of k for 256 FMAs; P ([128][64 + 8]) is read 2 keys
//   at a time beside 2 rows of V.
// - Occupancy. About 250 registers a thread, no spills (ptxas); at dh 64
//   104 KB of shared memory a CTA: two CTAs, 8 warps, per SM, so one
//   CTA's barriers and staging are covered by the other's FMAs.
// - Staging by cp.async (16 bytes a copy where dh % 4 == 0 and q, k, v,
//   o are 16-byte aligned, decided per call; 4 bytes otherwise; bf16
//   inputs, a rare path, are converted to f32 through registers). One
//   K/V stage: tile t + 1 is staged after tile t's P V, behind a barrier.
//   At dh 64 two stages would leave one CTA per SM, which ran 30% slower
//   on the card than one stage with two CTAs (at dh 128 two do not fit);
//   not restaging at all was only 6% faster.
// - Scale and exp. Q is staged once, scaled by log2(e) / sqrt(dh), so the
//   softmax runs on the SFU's ex2.
// - Order. Under causal masking the last q tiles see the most keys; they
//   are launched first (the q tile is the slowest grid index, reversed),
//   so the heaviest CTAs do not form the tail.
//
// Semantics kept from the TPU kernel: masked scores are -1e30 (not -inf:
// -inf - -inf is NaN), so a row that sees only masked keys so far carries
// weight 1 until a real score resets it through corr = 2^(m - m_new);
// columns past Skv (a ragged last tile) carry weight 0; the output is
// normalised once, by max(l, 1e-30). Kv tiles that every row of the q
// tile masks are skipped, unless some row has no key at all (a window
// that ends before Skv): then the CTA visits every tile, as the TPU
// kernel does, and that row gets the uniform average over all keys.
//
// The entry point returns cudaGetLastError() after its launch.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;          // keys per kv tile
constexpr int kTR = 8;           // rows of S and O per thread: rg + kRG i
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a CTA (bytes): Q [bq][ld], K and V [kBK][ld] and P
// [bq][pld], f32.
constexpr size_t smem_bytes(int bq, int ld, int pld) {
  return sizeof(float) * (bq * ld + 2 * kBK * ld + bq * pld);
}
// The shape of the work per head_dim bucket DB (32, 64, 128 or 256): kBQ
// query rows in kRG row groups and kCG column groups, so each thread
// holds 8 rows x kTC keys of S and 8 rows x NO = DB / kCG columns of O
// (NCH chunks of 4: u * 4 kCG + 4 cg + w). dh 128 takes 16 column groups
// and dh 256 32 (on 64 rows), which keeps their O tiles at 64 registers.
template <int DB>
struct Cfg {
  static constexpr int kBQ = DB == 256 ? 64 : 128;
  static constexpr int kRG = kBQ / kTR;
  static constexpr int kCG = DB == 256 ? 32 : DB == 128 ? 16 : 8;
  static constexpr int kThreads = kRG * kCG;
  static constexpr int kTC = kBK / kCG;
  static constexpr int NCH = DB / (4 * kCG);
  static constexpr int NO = 4 * NCH;
  // Row strides (floats): Q, K and V rows DB + 4 (DB / 4 + 1 is odd, so 8
  // consecutive rows fall on 8 distinct 16-byte bank groups); P rows
  // kBK + kCG (a warp's 32 / kCG rows of P fall on distinct banks).
  static constexpr int kLd = DB + 4;
  static constexpr int kPld = kBK + kCG;
  static constexpr int kMinBlocks = 256 / kThreads;
  static constexpr size_t kSmem = smem_bytes(kBQ, kLd, kPld);
  // kMinBlocks CTAs fit on an SM: 228 KB, 1 KB of it reserved per CTA.
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472,
                "a CTA's tiles do not fit");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// cp.async: a copy from device to shared memory that bypasses the
// registers and runs while the thread goes on; cp.async.wait_all waits for
// this thread's copies, which other threads see after a barrier.
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage one kv tile: rows [k0, k0 + ncol) of k and v (row stride rs
// elements from kb / vb) into Ks / Vs [kBK][LD], columns [0, dh); rows
// past ncol are zeros. VEC: 16-byte cp.async (f32, dh % 4 == 0, aligned);
// else 4-byte cp.async for f32, and loads converted to f32 for bf16.
template <typename T, bool VEC, int NT, int LD>
__device__ __forceinline__ void stage_kv(const T* kb, const T* vb,
                                         int64_t rs, int k0, int ncol,
                                         int dh, float* Ks, float* Vs) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    const int cpr = dh / 4;                  // 16-byte chunks per row
    for (int e = tid; e < kBK * cpr; e += NT) {
      const int c = e / cpr, d = (e - c * cpr) * 4;
      float* kd = Ks + c * LD + d;
      float* vd = Vs + c * LD + d;
      if (c < ncol) {
        const int64_t at = (k0 + c) * rs + d;
        cp_async16(kd, reinterpret_cast<const float*>(kb) + at);
        cp_async16(vd, reinterpret_cast<const float*>(vb) + at);
      } else {
        *reinterpret_cast<float4*>(kd) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(vd) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = tid; e < kBK * dh; e += NT) {
      const int c = e / dh, d = e - c * dh;
      float* kd = Ks + c * LD + d;
      float* vd = Vs + c * LD + d;
      if (c < ncol) {
        const int64_t at = (k0 + c) * rs + d;
        if constexpr (sizeof(T) == 4) {
          cp_async4(kd, reinterpret_cast<const float*>(kb) + at);
          cp_async4(vd, reinterpret_cast<const float*>(vb) + at);
        } else {
          *kd = to_f32(kb[at]);
          *vd = to_f32(vb[at]);
        }
      } else {
        *kd = 0.f;
        *vd = 0.f;
      }
    }
  }
}

// 2^x by the SFU (ex2.approx, relative error ~2^-22; denormal results
// flush to 0, weights far below the 2e-5 tolerance).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The keys row q may attend: [first_key, last_key]; empty if first > last.
__device__ __forceinline__ int first_key(int q, int window) {
  return window >= 0 ? max(0, q - window + 1) : 0;
}
__device__ __forceinline__ int last_key(int q, int Skv, int causal) {
  return causal ? min(q, Skv - 1) : Skv - 1;
}

template <typename T, int DB, bool VEC>
__global__ void __launch_bounds__(Cfg<DB>::kThreads, Cfg<DB>::kMinBlocks)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int B, int Sq,
             int Skv, int H, int KV, int dh, float qscale, int causal,
             int window) {
  using C = Cfg<DB>;
  constexpr int kBQ = C::kBQ, kRG = C::kRG;
  constexpr int kCG = C::kCG, kTC = C::kTC, NCH = C::NCH, NO = C::NO;
  constexpr int LD = C::kLd, PLD = C::kPld, NT = C::kThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dh4 = (dh + 3) / 4 * 4;
  float* Qs = smem;                               // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;                      // [kBK][LD]
  float* Vs = Ks + kBK * LD;                      // [kBK][LD]
  float* Ps = Vs + kBK * LD;                      // [kBQ][PLD]

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (B * H)) * kBQ;
  const int b = bh / H, h = bh % H, hk = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) * (32 / kCG) + lane / kCG, cg = lane % kCG;

  // Zero the pad columns [dh, LD) of every K and V row once: the copies
  // never write them, and K's meet Q's zero pad in Q K^T.
  for (int e = tid; e < 2 * kBK * (LD - dh); e += NT) {
    const int r = e / (LD - dh);
    Ks[r * LD + dh + (e - r * (LD - dh))] = 0.f;
  }
  // Q tile, scaled, rows past Sq and pad columns zero.
  {
    const int64_t rs = static_cast<int64_t>(H) * dh;
    const T* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * dh;
    for (int e = tid; e < kBQ * (LD / 4); e += NT) {
      const int r = e / (LD / 4), d = (e - r * (LD / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq) {
        const T* src = qb + (q0 + r) * rs + d;
        if constexpr (VEC) {
          if (d < dh) val = *reinterpret_cast<const float4*>(src);
        } else {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (d + w < dh) t[w] = to_f32(src[w]);
          val = make_float4(t[0], t[1], t[2], t[3]);
        }
      }
      val.x *= qscale;
      val.y *= qscale;
      val.z *= qscale;
      val.w *= qscale;
      *reinterpret_cast<float4*>(Qs + r * LD + d) = val;
    }
  }

  // The tiles to visit: all if some row has no key (rows without keys
  // are the last ones, since first - last grows with q), else the span.
  const int qlast = min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Skv + kBK - 1) / kBK;
  int lo = 0, hi = n_tiles;
  if (first_key(qlast, window) <= last_key(qlast, Skv, causal)) {
    lo = first_key(q0, window) / kBK;
    hi = last_key(qlast, Skv, causal) / kBK + 1;
  }

  const int64_t krs = static_cast<int64_t>(KV) * dh;
  const int64_t koff = (static_cast<int64_t>(b) * Skv * KV + hk) * dh;
  const T* kb = k + koff;
  const T* vb = v + koff;
  if (lo < hi) {
    stage_kv<T, VEC, NT, LD>(kb, vb, krs, lo * kBK,
                             min(kBK, Skv - lo * kBK), dh, Ks, Vs);
    cp_async_commit();
  }

  float m[kTR], l[kTR], acc[kTR][NO];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }
  const float* Qt = Qs + rg * LD;                 // this thread's rows
  float* Pt = Ps + rg * PLD;

  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kBK;
    const int ncol = min(kBK, Skv - k0);
    cp_async_wait_all();
    // Tile `tile` (and Q, the first time) is visible to every thread, and
    // every thread is done with the P of the tile before it.
    __syncthreads();

    // S = Q K^T, kTR x kTC per thread, 4 of dh a step.
    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
    const float* Kt = Ks + cg * LD;
#pragma unroll 2
    for (int d = 0; d < dh4; d += 4) {
      float4 kf[kTC];
#pragma unroll
      for (int j = 0; j < kTC; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Kt + kCG * j * LD + d);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(Qt + kRG * i * LD + d);
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    // Mask unless every (row, key) of the tile is kept: -1e30 where the
    // mask forbids, -inf (weight 0) past Skv.
    const bool whole = ncol == kBK && (!causal || k0 + kBK - 1 <= q0) &&
                       (window < 0 || k0 > q0 + kBQ - 1 - window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int qpos = q0 + rg + kRG * i;
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          const int kpos = k0 + cg + kCG * j;
          if (kpos >= Skv)
            s[i][j] = __int_as_float(0xff800000);  // -inf
          else if ((causal && kpos > qpos) ||
                   (window >= 0 && kpos <= qpos - window))
            s[i][j] = kNegInf;
        }
      }
    }

    // Online softmax per row, in log2 units; P to shared memory.
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kTC; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int x = 1; x < kCG; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const float p = fast_exp2(s[i][j] - m_new);
        Pt[kRG * i * PLD + cg + kCG * j] = p;
        rs += p;
      }
#pragma unroll
      for (int x = 1; x < kCG; x <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, x);
      const float corr = fast_exp2(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NO; ++c) acc[i][c] *= corr;
    }
    __syncwarp();                            // a row group's P is in its warp

    // O += P V, kTR x NO per thread, 2 keys a step.
    const float* Vt = Vs + cg * 4;
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 2) {
      float vf[2][NO];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          const float4 t = *reinterpret_cast<const float4*>(
              Vt + (kk + e) * LD + u * 4 * kCG);
          vf[e][u * 4 + 0] = t.x;
          vf[e][u * 4 + 1] = t.y;
          vf[e][u * 4 + 2] = t.z;
          vf[e][u * 4 + 3] = t.w;
        }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const float2 pf =
            *reinterpret_cast<const float2*>(Pt + kRG * i * PLD + kk);
#pragma unroll
        for (int c = 0; c < NO; ++c) {
          acc[i][c] = fmaf(pf.x, vf[0][c], acc[i][c]);
          acc[i][c] = fmaf(pf.y, vf[1][c], acc[i][c]);
        }
      }
    }

    if (tile + 1 < hi) {
      __syncthreads();                       // everyone is done with K, V
      stage_kv<T, VEC, NT, LD>(kb, vb, krs, k0 + kBK,
                               min(kBK, Skv - k0 - kBK), dh, Ks, Vs);
      cp_async_commit();
    }
  }

  // Normalise once and store the rows below Sq, the columns below dh.
  const int64_t ors = static_cast<int64_t>(H) * dh;
  T* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * dh;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int qpos = q0 + rg + kRG * i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* dst = ob + qpos * ors;
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int d = u * 4 * kCG + cg * 4;
      if constexpr (VEC) {
        if (d < dh)
          *reinterpret_cast<float4*>(dst + d) = make_float4(
              acc[i][u * 4] * inv, acc[i][u * 4 + 1] * inv,
              acc[i][u * 4 + 2] * inv, acc[i][u * 4 + 3] * inv);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (d + w < dh) store(acc[i][u * 4 + w] * inv, dst + d + w);
      }
    }
  }
}

template <typename T, int DB, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int dh, float qscale, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<DB>;
  const size_t smem = C::kSmem;
  const auto kernel = flash_kernel<T, DB, VEC>;
  // The attributes never change: set them once per instantiation and
  // device (bit `device` of `ready`), on the first launch there.
  static std::atomic<uint64_t> ready{0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (e == cudaSuccess && !(ready.load() & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) ready.fetch_or(bit);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (Sq + C::kBQ - 1) / C::kBQ;
  kernel<<<n_qt * B * H, C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), B, Sq, Skv, H, KV, dh,
      qscale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int dh, float qscale,
             int causal, int window, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32, VEC>(q, k, v, o, B, Sq, Skv, H, KV, dh, qscale,
                              causal, window, stream);
  if (dh <= 64)
    return launch<T, 64, VEC>(q, k, v, o, B, Sq, Skv, H, KV, dh, qscale,
                              causal, window, stream);
  if (dh <= 128)
    return launch<T, 128, VEC>(q, k, v, o, B, Sq, Skv, H, KV, dh, qscale,
                               causal, window, stream);
  return launch<T, 256, VEC>(q, k, v, o, B, Sq, Skv, H, KV, dh, qscale,
                             causal, window, stream);
}

}  // namespace

// window < 0 means no sliding window; is_bf16 selects bf16 over f32;
// scale is 1 / sqrt(dh).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int dh,
                                      int is_bf16, float scale, int causal,
                                      int window, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (dh < 1 || dh > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qscale = scale * kLog2e;
  if (is_bf16)
    return dispatch<__nv_bfloat16, false>(q, k, v, o, B, Sq, Skv, H, KV, dh,
                                          qscale, causal, window, s);
  // 16-byte copies where every row stride and base allows them.
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = dh % 4 == 0 && al16(q) && al16(k) && al16(v) && al16(o);
  return vec ? dispatch<float, true>(q, k, v, o, B, Sq, Skv, H, KV, dh,
                                     qscale, causal, window, s)
             : dispatch<float, false>(q, k, v, o, B, Sq, Skv, H, KV, dh,
                                      qscale, causal, window, s);
}
