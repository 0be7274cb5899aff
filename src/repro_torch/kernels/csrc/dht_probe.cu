// Blocked hashtable insert and lookup for NVIDIA Hopper (sm_90a): the
// §5.3 DHT hot loop. Replaces the Pallas TPU kernels `_insert_kernel`
// and `_lookup_kernel` of src/repro/kernels/dht_probe.py.
//
// Layout (as in the TPU kernels): the table is nb blocks of TB slots,
// keys are already routed to blocks, KB lanes per block, -1 = empty
// slot / padding lane. A key's slot is key mod TB (non-negative).
//
// What bounds them: bytes. Each lane does a handful of integer ops on
// one or two 4-byte words, so the insert is a copy of the table block
// plus a gather/scatter of one word per lane, and the lookup is a
// gather. Design:
//   * insert: one CTA per table block. The TPU kernel resolved slot
//     conflicts with dense [KB, TB] and [KB, KB] one-hot contractions;
//     here each valid lane does atomicMin(&win[slot], lane) on a
//     shared-memory array, which picks the FIRST lane per slot (the
//     arrival order of the reference's sequential CAS oracle; a plain
//     atomicCAS would pick an arbitrary winner). The block copy and
//     the probes are coalesced over threads; out of place, like JAX.
//   * lookup: one thread per lane, two dependent 4-byte loads.
//
// Status codes: 0 insert, 1 update, 2 overflow, 3 padding.
// Each entry point returns cudaGetLastError() after its launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kThreads = 256;

__device__ __forceinline__ int slot_of(int key, int TB) {
  int s = key % TB;              // C remainder takes the key's sign,
  return s < 0 ? s + TB : s;     // the reference's remainder does not
}

__global__ void insert_kernel(const int* __restrict__ tk,
                              const int* __restrict__ tv,
                              const int* __restrict__ keys,
                              const int* __restrict__ vals,
                              int* __restrict__ tk_out,
                              int* __restrict__ tv_out,
                              int* __restrict__ status, int TB, int KB) {
  extern __shared__ int win[];   // [TB]: lowest valid lane per slot
  const int64_t tb0 = static_cast<int64_t>(blockIdx.x) * TB;
  const int64_t kb0 = static_cast<int64_t>(blockIdx.x) * KB;
  for (int s = threadIdx.x; s < TB; s += blockDim.x) {
    win[s] = INT_MAX;
    tk_out[tb0 + s] = tk[tb0 + s];
    tv_out[tb0 + s] = tv[tb0 + s];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KB; i += blockDim.x) {
    const int k = keys[kb0 + i];
    if (k != kEmpty) atomicMin(&win[slot_of(k, TB)], i);
  }
  // Also orders the copy above before the winners' writes below.
  __syncthreads();
  for (int i = threadIdx.x; i < KB; i += blockDim.x) {
    const int k = keys[kb0 + i];
    int st = 3;
    if (k != kEmpty) {
      const int s = slot_of(k, TB);
      const int inc = tk[tb0 + s];
      if (inc != kEmpty && inc == k) {
        st = 1;
        tv_out[tb0 + s] = vals[kb0 + i];
      } else if (inc == kEmpty && win[s] == i) {
        st = 0;
        tk_out[tb0 + s] = k;
        tv_out[tb0 + s] = vals[kb0 + i];
      } else {
        st = 2;
      }
    }
    status[kb0 + i] = st;
  }
}

__global__ void lookup_kernel(const int* __restrict__ tk,
                              const int* __restrict__ tv,
                              const int* __restrict__ keys,
                              int* __restrict__ vals_out,
                              uint8_t* __restrict__ hit_out, int64_t n_lanes,
                              int TB, int KB) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (g >= n_lanes) return;
  const int k = keys[g];
  int v = kEmpty;
  uint8_t hit = 0;
  if (k != kEmpty) {
    const int64_t at = (g / KB) * TB + slot_of(k, TB);
    if (tk[at] == k) {
      hit = 1;
      v = tv[at];
    }
  }
  vals_out[g] = v;
  hit_out[g] = hit;
}

}  // namespace

extern "C" int dht_insert_launch(const int* tk, const int* tv,
                                 const int* keys, const int* vals,
                                 int* tk_out, int* tv_out, int* status,
                                 int nb, int TB, int KB, void* stream) {
  if (nb == 0 || KB == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(TB) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  insert_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tk, tv, keys, vals, tk_out, tv_out, status, TB, KB);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dht_lookup_launch(const int* tk, const int* tv,
                                 const int* keys, int* vals_out,
                                 uint8_t* hit_out, int nb, int TB, int KB,
                                 void* stream) {
  const int64_t n = static_cast<int64_t>(nb) * KB;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      tk, tv, keys, vals_out, hit_out, n, TB, KB);
  return static_cast<int>(cudaGetLastError());
}
