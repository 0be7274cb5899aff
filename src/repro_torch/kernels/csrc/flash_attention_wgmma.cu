// Flash attention (GQA, causal, optional sliding window) in bf16 on the
// tensor cores of NVIDIA Hopper (sm_90a): `wgmma` products fed by TMA.
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py for bf16 inputs whose head_dim
// is a multiple of 16 up to 192 (DeepSeek-V3's MLA prefill runs 192);
// flash_attention.cu keeps f32 and every other bf16 shape (the rule is in
// kernels/flash_attention.py).
//
// Semantics (the TPU kernel's): q [B, Sq, H, dh], k/v [B, Skv, KV, dh]
// bf16, contiguous; query head h reads KV head h / (H / KV). Scores
// (q k^T) / sqrt(dh) accumulate in f32; masked scores are -1e30 (causal:
// kpos > qpos; window: kpos <= qpos - window); an online softmax keeps
// m and l in f32; the output is normalised once by max(l, 1e-30) and
// written in bf16. P is rounded to bf16 for the P V product (the plain
// version does the same for these shapes).
//
// What bounds it on this card: operations at Qwen2-0.5B's prefill shapes
// (B 4, S 1024, H 14, KV 2, dh 64: ~7.5 GFLOP against 16.8 MB, far above
// the card's ~295 bf16 ops per byte); at DeepSeek-V3's MLA layer (B 4, S
// 1024, H = KV = 128, dh 192: 2.06e11 flop against 805 MB, 256 ops per
// byte) bytes by a little (0.240 ms against 0.208 ms of operations). So
// both products run on `wgmma`, and the kernel keeps the tensor cores
// fed while it reads each byte once:
//
// - One CTA per (b, h, 128-row q tile): three warpgroups. Warpgroups 0
//   and 1 (consumers) own 64 query rows each; warpgroup 2 (producer)
//   gives its registers away (`setmaxnreg`) and one of its threads
//   issues every TMA load.
// - TMA loads q once and each k/v tile of kBKV rows into a ring of
//   kStages stages, signalled by `mbarrier`s (full: bytes landed; empty:
//   all 8 consumer warps done with the stage). Tensor maps are 3-D, [B]
//   [S][heads * dh] with row stride heads * dh * 2 bytes: a tile that
//   runs past S reads zeros instead of the next batch's rows. Tiles are
//   64 columns (128 bytes) wide with the 128-byte swizzle that the
//   `wgmma` descriptors name; dh <= 64 takes one such slab, dh <= 128
//   two, dh <= 192 three (one TMA box per slab). The maps are built on
//   the host with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
//   parameters.
// - Tile sizes (Tile<>): shared memory holds Q (kSlabs x 16 KB) and the
//   k/v ring (2 kStages kSlabs kBKV 128 bytes) in the 227 KB a block may
//   have. One or two slabs take kBKV 128 and two stages (81 / 161 KB);
//   three slabs at 128 would need 241 KB. Timed at DeepSeek-V3's layer
//   (kernel_time.py --kernel flash_attention_wgmma192, in turns on one
//   H100 80GB HBM3 at 700 W), 64 rows in three stages (193 KB) ran 0.92
//   ms, 7% faster than 112 (FA3's hdim-192 choice, 217 KB), 96 or 64
//   rows in two stages (0.98-0.99 ms) and 19% faster than 128 in one
//   (1.13 ms): three slabs take it. One CTA per SM at every dh.
// - S = Q K^T: dh / 16 `wgmma.m64n{kBKV}k16` with Q and K from shared
//   memory (both K-major; the descriptor steps 32 bytes within a slab,
//   then to the next slab). O += P V: kBKV / 16 `wgmma.m64n{DHP}k16`
//   (DHP = 64, 128 or 192) with P from registers (the S accumulator
//   converted to bf16 in place: its fragment is the A operand's) and V
//   from shared memory, MN-major through the transpose bit, its slabs
//   kBKV * 128 bytes apart (the descriptor's leading offset). Columns of
//   a slab past dh are never read by Q K^T and land in output columns
//   that are not stored.
// - Registers: a consumer thread holds O (DHP / 2 f32: 96 at dh 192), S
//   (kBKV / 2) and P (kBKV / 4, bf16 pairs) under `setmaxnreg` 240.
//   ptxas (CUDA 12.8, -O3): every instantiation, dh 16-192, 168
//   registers at launch (384 threads, one CTA per SM), 0 bytes of spill
//   stores and loads, 0 stack.
// - Where dh 192's time goes (the same script, edited copies): without
//   the softmax and O's rescale the kernel ran 0.59 ms of 0.92; without
//   the per-score work alone (scale, mask, exp2) 0.85, with every CTA
//   reading one head's k/v (all L2 hits) 0.86, both 0.78. So the row
//   reductions, O's rescale and the steps they serialise cost most, not
//   memory. FA3's intra-warpgroup overlap (a tile's softmax beside the
//   previous tile's P V) gained 2%, its warpgroup ping-pong 2-3%, CTAs
//   grouped so their k/v fit in L2 2-8%, exp2 without subnormals 1-2%;
//   none is kept (PERF.md).
// - Each row's max and sum live in the 4 threads of a quad (two
//   shuffles). Only tiles that cross the causal diagonal, the window's
//   edge or Skv are masked; columns past Skv weigh 0 (-inf, not -1e30).
// - Causal tile skipping: kv tiles that every row of the CTA masks are
//   not loaded. If some row of the q tile has no key at all, the CTA
//   visits every tile, so that row averages all values, as the TPU
//   kernel does. The heaviest q tiles are launched first (reverse
//   q-tile order, the q tile the slowest grid index), so the causal
//   imbalance does not leave a tail wave.
//
// The entry point returns cudaGetLastError() after its launch, or
// kNoDriverEntry / kEncodeFailed + CUresult if a tensor map cannot be
// built.

#include <cmath>
#include <cstdint>

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;              // query rows per CTA
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNoDriverEntry = 999;
constexpr int kEncodeFailed = 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A `wgmma` shared-memory descriptor for a 128-byte-swizzled tile.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory
// (S = Q K^T: N is the kv tile's rows).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major
// (transposed) in shared memory (O += P V: N is dh padded to slabs).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Keys query row r may attend: [first_key, last_key] (empty if first >
// last). The emptiness test is monotone in r, so the last row decides.
__device__ __forceinline__ int first_key(int r, int window) {
  return window >= 0 ? max(0, r - window + 1) : 0;
}
__device__ __forceinline__ int last_key(int r, int Skv, int causal) {
  return causal ? min(r, Skv - 1) : Skv - 1;
}

// The tiles of head_dim dh = 16 kSteps (kSteps, the k16 steps of Q K^T, is
// a compile-time count, which keeps the wgmma chain free of branches):
// DHP, dh padded to kSlabs whole 64-column slabs; kBKV kv rows per tile
// and a ring of kStages k/v stages. One or two slabs take 128 kv rows in
// two stages; three slabs at 128 would need 246,784 bytes of shared
// memory, over the 232,448 a block may have, so they take 64 rows in
// three stages (the fastest of the tile sets timed: see the header).
template <int kSteps>
struct Tile {
  static constexpr int kSlabs = (kSteps + 3) / 4;
  static constexpr int DHP = 64 * kSlabs;
  static constexpr int kBKV = kSlabs <= 2 ? 128 : 64;
  static constexpr int kStages = kSlabs <= 2 ? 2 : 3;
  static constexpr int kSmem =
      1024 + kSlabs * 128 * (kBQ + 2 * kStages * kBKV)
      + (2 * kStages + 1) * static_cast<int>(sizeof(uint64_t));
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

template <int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int B, int Sq, int Skv,
                   int H, int KV, float scale_log2, int causal,
                   int window) {
  using T = Tile<kSteps>;
  constexpr int dh = kSteps * 16, DHP = T::DHP, kSlabs = T::kSlabs;
  constexpr int kBKV = T::kBKV, kStages = T::kStages;
  constexpr uint32_t kQBytes = kSlabs * kBQ * 128;
  constexpr uint32_t kKVBytes = kSlabs * kBKV * 128;
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align every tile so.
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + kQBytes;
  uint8_t* sv = sk + kStages * kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // Heaviest q tiles first: the q tile is the slowest grid index.
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - blockIdx.x / (B * H)) * kBQ;
  const int b = bh / H, h = bh % H, hk = h / (H / KV);

  const int qlast = min(q0 + kBQ, Sq) - 1;
  int lo = 0, hi = (Skv + kBKV - 1) / kBKV;
  if (first_key(qlast, window) <= last_key(qlast, Skv, causal)) {
    lo = first_key(q0, window) / kBKV;
    hi = last_key(qlast, Skv, causal) / kBKV + 1;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);     // one arrive per warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qbar, kQBytes);
      for (int s = 0; s < kSlabs; ++s)
        tma_load(sq + s * kBQ * 128, &tq, qbar, h * dh + 64 * s, q0, b);
      for (int it = 0; it < hi - lo; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kKVBytes);
        const int k0 = (lo + it) * kBKV;
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(sk + st * kKVBytes + s * kBKV * 128, &tk, &full[st],
                   hk * dh + 64 * s, k0, b);
          tma_load(sv + st * kKVBytes + s * kBKV * 128, &tv, &full[st],
                   hk * dh + 64 * s, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int wrow0 = q0 + wg * 64;                 // warpgroup's rows
    const int row0 = wrow0 + warp * 16 + lane / 4;  // rows row0, row0 + 8
    float oacc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(sq) + wg * 64 * 128;

    mbar_wait(qbar, 0);
    for (int it = 0; it < hi - lo; ++it) {
      const int st = it % kStages;
      const int k0 = (lo + it) * kBKV;
      mbar_wait(&full[st], (it / kStages) & 1);

      // S = Q K^T over dh in steps of 16 (32 bytes of a 128-byte row).
      float s[kBKV / 2];
      const uint32_t k_base = smem_u32(sk + st * kKVBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;       // within the slab
        wgmma_ss<kBKV>(
            s, sw128_desc(q_base + (kk / 4) * kBQ * 128 + off, 16, 1024),
            sw128_desc(k_base + (kk / 4) * kBKV * 128 + off, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // Scale (to log2 units: exp2 then gives e^(score - m)) and mask.
      // Thread (lane) holds rows row0 + 8 i and columns k0 + 8 j + 2 t + e
      // in s[4 j + 2 i + e]. A masked score is -1e30 in these units too:
      // what matters is that it weighs 0 beside a real score and 1 in a
      // row with none, as in the TPU kernel.
      const bool whole = (!causal || k0 + kBKV - 1 <= wrow0)
                         && (window < 0 || k0 > wrow0 + 63 - window)
                         && k0 + kBKV <= Skv;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = s[4 * j + 2 * i + e] * scale_log2;
            if (!whole) {
              const int col = k0 + 8 * j + 2 * t + e, row = row0 + 8 * i;
              if (col >= Skv)
                v = -INFINITY;                      // weighs 0
              else if ((causal && col > row)
                       || (window >= 0 && col <= row - window))
                v = kNegInf;
            }
            s[4 * j + 2 * i + e] = v;
            mx[i] = fmaxf(mx[i], v);
          }
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * i + e] - m[i]);
            s[4 * j + 2 * i + e] = p;
            rs[i] += p;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * corr[i] + rs[i];
      }
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          oacc[4 * j + 2 * i] *= corr[i];
          oacc[4 * j + 2 * i + 1] *= corr[i];
        }
      }
      // P in bf16: the S fragment of columns 16 kk .. 16 kk + 15 is the
      // A fragment of the kk-th k16 step.
      uint32_t pa[kBKV / 4];
#pragma unroll
      for (int c = 0; c < kBKV / 4; ++c)
        pa[c] = pack_bf16(s[2 * c], s[2 * c + 1]);

      // O += P V over the tile's kv rows in steps of 16 (2048 bytes).
      const uint32_t v_base = smem_u32(sv + st * kKVBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        const uint64_t db = sw128_desc(v_base + kk * 16 * 128,
                                       kBKV * 128, 1024);
        wgmma_rs<DHP>(oacc, &pa[4 * kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* out =
          o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * dh;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < dh)
          *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(
              oacc[4 * j + 2 * i] / den, oacc[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A 3-D map over [B][S][cols] bf16 with 64-column x `rows`-row boxes,
// 128-byte swizzle; out-of-bounds elements read as zeros.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int cols,
           int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return kNoDriverEntry;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(S) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int kSteps>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  using T = Tile<kSteps>;
  constexpr int dh = kSteps * 16;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, B, Sq, H * dh, kBQ);
  if (err == 0) err = encode(&tk, k, B, Skv, KV * dh, T::kBKV);
  if (err == 0) err = encode(&tv, v, B, Skv, KV * dh, T::kBKV);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<kSteps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = ((Sq + kBQ - 1) / kBQ) * B * H;
  flash_wgmma_kernel<kSteps><<<grid, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, Sq, Skv, H, KV,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The signature of flash_attention_launch; is_bf16 must be 1, dh a
// multiple of 16 up to 192, Skv >= 1; window < 0 means no sliding
// window. q/k/v 16-byte aligned (TMA's rule).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int Sq, int Skv, int H, int KV,
                                            int dh, int is_bf16, float scale,
                                            int causal, int window,
                                            void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (!is_bf16 || dh < 16 || dh > 192 || dh % 16 != 0 || KV < 1
      || H % KV != 0 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh / 16) {
#define FLASH_STEPS(n)                                                    \
  case n:                                                                 \
    return launch<n>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, \
                     s);
    FLASH_STEPS(1) FLASH_STEPS(2) FLASH_STEPS(3) FLASH_STEPS(4)
    FLASH_STEPS(5) FLASH_STEPS(6) FLASH_STEPS(7) FLASH_STEPS(8)
    FLASH_STEPS(9) FLASH_STEPS(10) FLASH_STEPS(11) FLASH_STEPS(12)
#undef FLASH_STEPS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
