// Flash attention (GQA, causal, optional sliding window) for NVIDIA
// Hopper (sm_90a). Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py.
//
// Layout (as in the TPU kernel): q [B, Sq, H, dh], k/v [B, Skv, KV, dh],
// f32 or bf16, contiguous; the output has q's shape and dtype. Query
// head h reads KV head h / (H / KV). Any Sq and Skv (tiles are bounds-
// checked); dh <= 128.
//
// What bounds it on this card: operations. At the model's shapes
// (S 1024, dh 64) the two products do ~S/4 operations per byte of
// q/k/v/o, far above the card's ~295 ops/byte balance point. This first
// version is the simple one: f32 FMAs on CUDA cores (no tensor cores, no
// TF32, whose 10-bit mantissa would miss the f32 tolerance of 2e-5), so
// it sits far from the tensor-core bound; `wgmma` + TMA is later work.
//
// Design: one CTA of 256 threads per (b, h, 64-row q tile); the TPU
// kernel's sequential kv grid axis becomes a loop inside the CTA. The q
// tile (pre-scaled by 1/sqrt(dh), as the TPU kernel does) and each 64-row
// k/v tile are staged in shared memory as f32. Four threads own one query
// row: each computes 16 of the tile's 64 scores and 1/4 of the row's
// output columns, so the running max m, sum l and accumulator stay in
// registers (f32), and row reductions are two shuffles within the quad.
// Masked scores are -1e30 (not -inf: -inf - -inf is NaN) exactly as in
// the TPU kernel, so a row that sees only masked keys so far carries
// weight 1 until a real score resets it through corr = exp(m - m_new).
// Columns past Skv (a ragged last tile) carry weight 0. The output is
// normalised once, by max(l, 1e-30).
//
// Tile skipping: kv tiles that every row of the q tile masks (above the
// causal diagonal, or before the window) are skipped. That leaves the
// result unchanged whenever every row has at least one key it may
// attend; if some row has none (a window that ends before Skv), the CTA
// visits all tiles, as the TPU kernel does, so that row gets the same
// uniform average over all keys.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 4 threads per query row
constexpr int kCols = kBK / 4;   // scores per thread per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int dh) {
  // Qs [kBQ][dh+1], Ks [kBK][dh+1], Vs [kBK][dh], Ps [kBQ][kBK+1], f32.
  return sizeof(float) * (static_cast<size_t>(kBQ) * (dh + 1)
                          + static_cast<size_t>(kBK) * (dh + 1)
                          + static_cast<size_t>(kBK) * dh
                          + static_cast<size_t>(kBQ) * (kBK + 1));
}

// NACC = output columns per thread, ceil(dh_max / 4).
template <typename T, int NACC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int H, int KV, int dh, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = dh + 1;                     // padded: no bank conflicts
  float* Qs = smem;
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ps = Vs + kBK * dh;                 // [kBQ][kBK + 1]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, r = tid >> 2, t = tid & 3;
  const int qpos = q0 + r;
  const bool row_ok = qpos < Sq;

  for (int e = tid; e < kBQ * dh; e += kThreads) {
    const int rr = e / dh, d = e % dh;
    float val = 0.f;
    if (q0 + rr < Sq) {
      const int64_t at =
          ((static_cast<int64_t>(b) * Sq + q0 + rr) * H + h) * dh + d;
      val = to_f32(q[at]) * scale;
    }
    Qs[rr * ld + d] = val;
  }

  // Keys row qpos may attend: [first, last]; empty if first > last.
  const int first = window >= 0 ? max(0, qpos - window + 1) : 0;
  const int last = causal ? min(qpos, Skv - 1) : Skv - 1;
  const int n_tiles = (Skv + kBK - 1) / kBK;
  int lo = 0, hi = n_tiles;
  // Also the barrier after the q tile's load.
  if (!__syncthreads_or(row_ok && first > last)) {
    const int qlast = min(q0 + kBQ, Sq) - 1;
    const int f0 = window >= 0 ? max(0, q0 - window + 1) : 0;
    const int l1 = causal ? min(qlast, Skv - 1) : Skv - 1;
    lo = f0 / kBK;
    hi = l1 / kBK + 1;
  }

  float m = kNegInf, l = 0.f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kBK;
    const int ncol = min(kBK, Skv - k0);
    __syncthreads();                         // last tile's readers are done
    for (int e = tid; e < kBK * dh; e += kThreads) {
      const int c = e / dh, d = e % dh;
      float kv = 0.f, vv = 0.f;
      if (c < ncol) {
        const int64_t at =
            ((static_cast<int64_t>(b) * Skv + k0 + c) * KV + hk) * dh + d;
        kv = to_f32(k[at]);
        vv = to_f32(v[at]);
      }
      Ks[c * ld + d] = kv;
      Vs[c * dh + d] = vv;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = Qs[r * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = fmaf(qd, Ks[(t + 4 * j) * ld + d], s[j]);
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + t + 4 * j;
      if ((causal && kpos > qpos) || (window >= 0 && kpos <= qpos - window))
        s[j] = kNegInf;
      if (t + 4 * j < ncol) mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = t + 4 * j;
      const float p = c < ncol ? expf(s[j] - m_new) : 0.f;
      Ps[r * (kBK + 1) + c] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float corr = expf(m - m_new);
    l = l * corr + rs;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= corr;
    __syncwarp();                            // a row's quad shares a warp
    for (int c = 0; c < ncol; ++c) {
      const float p = Ps[r * (kBK + 1) + c];
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int d = t + 4 * i;
        if (d < dh) acc[i] = fmaf(p, Vs[c * dh + d], acc[i]);
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    const int64_t base = ((static_cast<int64_t>(b) * Sq + qpos) * H + h) * dh;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = t + 4 * i;
      if (d < dh) store(acc[i] / den, &o[base + d]);
    }
  }
}

template <typename T, int NACC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int dh, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, NACC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, dh,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int dh, float scale, int causal,
             int window, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 8>(q, k, v, o, B, Sq, Skv, H, KV, dh, scale, causal,
                        window, stream);
  if (dh <= 64)
    return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, dh, scale, causal,
                         window, stream);
  return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, dh, scale, causal,
                       window, stream);
}

}  // namespace

// window < 0 means no sliding window; is_bf16 selects bf16 over f32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int dh,
                                      int is_bf16, float scale, int causal,
                                      int window, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (dh < 1 || dh > 128 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV,
                                           dh, scale, causal, window, s)
                 : dispatch<float>(q, k, v, o, B, Sq, Skv, H, KV, dh, scale,
                                   causal, window, s);
}
