// Fused no-grad SDF-MLP forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces s_volsdf_tpu/ops/pallas/fused_sdf.py::_kernel (pl.pallas_call
// in _fused_call, the Pallas TPU kernel behind fused_sdf_values). For
// each point it computes the positional encoding [x, sin(2^k x),
// cos(2^k x)], a chain of dense layers W = g*v/||v||_0 with one skip
// concat [h, pe] * 1/sqrt(2), softplus(100 h)/100 between layers, and
// only column 0 of the last layer (the SDF), clamped by
// sphere_scale * (bounding_sphere - ||x||) when bounding_sphere > 0.
//
// The bound. At the dtu width (9 layers, 256 wide, skip at 4, multires
// 6; SDF column only, K padded to 4) a point costs 10,240 + 2*65,536 +
// 55,552 + 4*65,536 + 256 = 459,264 multiply-adds (0.9185 MFLOP), so a
// sweep of 65,536 points is 60.2 GFLOP: 0.90 ms at the 67 TFLOP/s FP32
// peak, 0.37 ms as three TF32 products (495/3 TFLOP/s), 0.18 ms as
// three bf16 products (989/3 TFLOP/s). Inputs and outputs are 16 bytes
// a point; the work is operations, not bytes.
//
// The design (see ops/fused_sdf.py for the pack):
//   * f32 accuracy from bf16 tensor cores: every operand is split into
//     hi = bf16(x) and lo = bf16(x - hi), and each layer is
//     A_hi W_hi + A_lo W_hi + A_hi W_lo accumulated in f32 (wgmma
//     m64n256k16). The dropped A_lo W_lo term and the split's residual
//     are about 2^-16 of each product; the sampler's discrete choices
//     flip on small SDF differences, so one bf16 or TF32 pass is not
//     enough.
//   * a block holds 128 points: two consumer warpgroups of 64 rows each.
//     Every hidden layer is one N = 256 product (zero-padded) over
//     K chunks of 64 (one 128-byte swizzle row of bf16), the bias
//     preloaded into the accumulator. The warps' roles come from a
//     warp-uniform index and a producer warpgroup hands its registers
//     to the consumers (setmaxnreg), so ptxas keeps the wgmma chain
//     asynchronous.
//   * the wrapper packs the weights once per weight version as one
//     stream of 32 KB stages (W_hi then W_lo of each K chunk of each
//     layer, transposed to (out, in), i.e. K-major, zero-padded and
//     already in the 128-byte swizzled image the wgmma descriptors
//     read). One producer thread keeps STAGES of them in flight with
//     TMA bulk copies (cp.async.bulk) completing on mbarriers; the
//     consumers release each stage once their products on it are done.
//   * activations never leave the SM: the accumulator gets its bias and
//     softplus in registers, is split hi/lo and written as the next
//     layer's A operand (128 x 256 bf16, twice) in shared memory. The
//     skip junction's encoding is written after that epilogue (one
//     sincosf per octave and coordinate; the 1/sqrt(2) is folded into
//     the weights). The last layer is a per-point dot product with the
//     SDF column in the epilogue of the last hidden layer, then the
//     bounding-sphere clamp.
//
// What limits it (PERF.md; tools/time_fused_sdf.py --trace): 46% of the
// bf16 x 3 bound at 65,536 points and 53% at 2,097,152 on an H100 SXM
// at 700 W. Within a block the products run at about 90% of the tensor
// cores' peak (wgmma issue and ring waits included), but the two
// warpgroups run in step, so the epilogue (about 5.5K cycles a layer,
// bound by its two MUFU operations per activation) does not overlap
// the products and takes a third of the block's time. Each block
// re-reads the weight stream (1.9 MB at the dtu width) from L2; the
// 3-stage ring hides it. Shared memory (two 64 KB A operands and the
// 96 KB ring) allows one block per SM.
//
// The bfloat16 mode (mode 1, SdfMeta): what s_volsdf_tpu/models/
// network.py:sdf_values computes under compute_dtype="bfloat16", the
// JAX training step's default. Its arithmetic:
//   * every layer input is rounded to nearest bf16 and each layer is
//     the one product A W_hi (W_hi = bf16(W), rounded to nearest),
//     accumulated in f32 on top of the f32 bias, K chunk by K chunk in
//     the float32 mode's order. The pack holds only W_hi;
//   * with activation_dtype="bfloat16" the pre-activation is rounded to
//     bf16 before the softplus, and the softplus is computed op by op in
//     bf16 as JAX's bf16 program computes it (h.astype(bf16), then
//     jax.nn.softplus(100 h) / 100 on bf16 values): 100 h, exp(-|z|),
//     log1p, max(z, 0) + log1p and the quotient each rounded to bf16;
//   * the 1/sqrt(2) of the skip junction is NOT folded into the
//     weights: the epilogue multiplies the junction's activations and
//     encoding by it (bf16(1/sqrt(2)) with bf16 activations) and rounds
//     the product, where JAX's bf16 multiply rounds. A fold would round
//     W/sqrt(2) instead, one more rounding against JAX;
//   * the SDF column is bf16-rounded in the pack and its dot product
//     with the rounded activations is exact per term and summed in f32,
//     plus the f32 bias; the sphere clamp is f32.
// Its bound at the dtu width: 60.2 GFLOP per 65,536 points at 989
// TFLOP/s, 0.061 ms (1.95 ms per 2,097,152 points), a third of the
// x3 mode's. Run on the float32 mode's schedule it took 0.61 ms
// (PERF.md): the op-by-op softplus (five roundings on the integer units,
// two MUFU operations, a log1p series) made the epilogue 83% of a
// block's cycles, the two warpgroups in step left the tensor cores idle
// through it, and every block re-read the weight stream from L2. Its
// own schedule (fused_sdf_bf16_kernel):
//   * an exact activation without the MUFU chain (act2_bf16): it is a
//     function of bf16(z) alone, so inside the band 2^-16 <= |h| < 1 it
//     is a table of torch's bf16 ops (4,098 entries, 8 KB, built once a
//     process on the card, ops/fused_sdf.py act_bf16_table, at the start
//     of shared memory) and outside it closed forms: the value of 0
//     below, 0 for h <= -1, bf16(bf16(100 h) * 0.01f) for h >= 1, where
//     exp(-|100 h|) is past every rounding. A pair of values takes about
//     25 instructions, 13 on the integer units, and two table reads;
//     fused_sdf_act_bf16 runs the same function;
//   * each layer's A operand in registers (wgmma's register fragment has
//     the accumulator's layout): the epilogue packs the activations
//     straight into the next layer's operand, with no shared-memory
//     stores, proxy fences or group barriers between layers; 64
//     registers beside the accumulator's 128;
//   * the room A_hi and A_lo take in the float32 mode holds a deeper
//     ring (as many 32 KB stages as fit, up to 8: 6 at the dtu width)
//     and each tile's encoding;
//   * each weight stage read once from L2 for 256 points: clusters of 2
//     blocks, each block's producer copying half of every stage into
//     both blocks' rings (cp.async.bulk multicast); a stage is refilled
//     once both consumer warpgroups of both blocks release it;
//   * a persistent grid: as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters) walk pairs of tiles, the ring
//     running on from tile to tile, the table copied once a block;
//   * the two consumer warpgroups take turns on the tensor cores (two
//     named barriers; the turn passes once a group's last chunk of a
//     layer is issued), so one group's epilogue runs beside the other's
//     products.
//   None of them changes the order of a row's sums, so its outputs equal
//   the float32 schedule's bit for bit (tools/time_fused_sdf.py --other
//   against a tree that ran the bfloat16 mode on it). The producer's
//   wait traps after WAIT_LIMIT_CYCLES: a stalled ring raises, it never
//   hangs the card.
// What limits it (PERF.md; tools/time_fused_sdf.py --trace, on an H100
// SXM at 700 W): 6.3-6.6 ms at 2,097,152 points, 30% of the bound. A
// tile of 128 points takes about 91K cycles: per 256-wide layer each
// warpgroup spends about 5K cycles from its turn to its products' end
// (its own products are 2K at the tensor cores' rate) and 3.5-4.5K in
// the epilogue; the skip junction's epilogue takes 13-19K and the SDF
// layer's 4-8K, their unrolled code run once a tile. The activation is
// the largest part: a build without it (wrong values) runs at 4.2 ms,
// one with conflict-free table reads at 6.2 ms; the order of the turns
// moves the time by 5% at most, and a 5-stage ring not at all.
//
// The scene axis (fused_sdf_forward_scenes): S scenes' points, weight
// streams and vectors laid out one scene after another, one launch for
// all (blockIdx.y the scene in the float32 mode; in the bfloat16 mode
// the pairs of tiles of all scenes in one sequence, scene q / pairs).
// Each tile moves its pointers to its scene's and does what a single
// launch's tile does, so the batched launch equals S single launches
// bit for bit (the lockstep multi-scene step's sweep,
// s_volsdf_tpu_torch/engine/multiscene.py; the counterpart of the
// leading grid axis JAX's batching rule gives a vmapped pallas_call).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (see s_volsdf_tpu_torch/ops/fused_sdf.py); plain C entry points, bound
// with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LAYERS 16
#define TILE_P 128                  // points per block
#define N_CONSUMER 256              // two consumer warpgroups, 64 rows each
#define N_THREADS (N_CONSUMER + 128) // + one producer warpgroup
#define WIDTH 256                   // N of every hidden product
#define KCHUNK 64                   // K per chunk: 128 bytes of bf16
#define MAX_CHUNKS (WIDTH / KCHUNK)
#define STAGE_BYTES (WIDTH * KCHUNK * 2)         // one chunk of W_hi or W_lo
#define A_CHUNK_BYTES (TILE_P * KCHUNK * 2)      // one K chunk of A_hi or A_lo
#define A_BYTES (MAX_CHUNKS * A_CHUNK_BYTES)
#define SMEM_ALIGN 1024                          // the 128-byte swizzle's period
// The float32 mode: A_hi and A_lo, a ring of 3 stages.
#define STAGES 3
#define SMEM_BYTES (SMEM_ALIGN + 2 * A_BYTES + STAGES * STAGE_BYTES \
                    + TILE_P * 3 * 4 + 2 * STAGES * 8)
// The bfloat16 mode: the activation's table, a ring of up to MAX_RING
// stages, the tile's encoding; blocks in clusters of 2 sharing each
// stage.
#define CLUSTER 2
#define MAX_RING 8
#define HALF_STAGE_BYTES (STAGE_BYTES / CLUSTER)
#define ACT_LO 0x3780u              // bf16 bits of 2^-16: the band's |h| from
#define ACT_HI 0x3F80u              // ... and of 1.0: up to
#define ACT_SPAN (ACT_HI - ACT_LO)  // band entries of each sign
// The table: below the band, the band, the sentinel; whole 16 bytes.
#define ACT_TABLE_BYTES ((2 * ACT_SPAN + 2 + 7) / 8 * 16)
#define MAX_DEVICES 16
#define MAX_MULTIRES 10             // d_pe <= 63 (ops/fused_sdf.py supported)
// Cycles a wait may take before the block traps (about 9 s at 1.98 GHz).
#define WAIT_LIMIT_CYCLES (1ll << 34)

// Layer table, passed by value (mirrored by SdfMeta in ops/fused_sdf.py).
struct SdfMeta {
  int n_hidden;     // layers with a softplus; the SDF layer follows them
  int n_stages;     // 32 KB stages in the weight stream
  int skip;         // layer whose input is [h, pe] (-1: none; n_hidden: the SDF layer)
  int pe_col;       // first column of pe in that input
  int d_pe;         // 3 * (1 + 2 * multires)
  int mode;         // 0: float32 (bf16 x 3 split); 1: bfloat16 (one bf16 product)
  int act_bf16;     // bfloat16 mode: activations rounded to bf16
  float bounding_sphere;
  float sphere_scale;
  float skip_scale; // bfloat16 mode: the junction's 1/sqrt(2) (float32 mode: folded)
  int chunks[MAX_LAYERS];   // K chunks of each hidden layer
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA bulk copies --------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

// The same, trapping after WAIT_LIMIT_CYCLES. (Only outside a wgmma
// chain: a trap among the wgmma makes ptxas serialise them.)
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity) {
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > WAIT_LIMIT_CYCLES) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
      :: "r"(bar) : "memory");
}

// Arrives on the barrier at shared address `bar` of the cluster's block
// `rank` (this block's own, or the other's). Release at the block's
// scope: what it orders are this block's wgmma reads of a stage, done
// before, against the copy that refills it.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
      :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The copy into shared address `dst` of every block of the cluster in
// `mask`, each completing on its own barrier at shared address `bar`.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of both blocks of the cluster. The two spellings (the
// same barrier) keep the compiler from merging the producer's and the
// consumers' last syncs below their role branches: paths that meet again
// make ptxas ignore setmaxnreg.
template <bool kConsumer = false>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kConsumer)
    asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;"
                 ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.release;\n\t"
                 "barrier.cluster.wait.acquire;" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)1 << 16)              // leading offset: unused here
         | ((uint64_t)(1024 >> 4) << 32)    // stride offset: 8 rows
         | ((uint64_t)1 << 62);             // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A (64 x 16) B (16 x 256), both bf16 K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Keeps the compiler from reusing the registers of a register A operand
// before the wgmma that reads them has been waited for.
__device__ __forceinline__ void fence_a(uint32_t* a, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// d += A (64 x 16, bf16 in registers: wgmma's register fragment, the
// accumulator's layout) B (16 x 256, bf16 K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_m64n256k16(float* d, const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- the epilogue's arithmetic ------------------------------------------

// softplus(100 h) / 100 in jax.nn.softplus's form, max(z, 0) +
// log1p(exp(-|z|)) with z = 100 h, as two MUFU operations: exp2 and log2
// (flushed to zero: an exp(-|z|) below 1e-38 adds nothing to 1). Within
// about 2e-9 of the exact form.
__device__ __forceinline__ float softplus100(float h) {
  float t, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(-144.26950408889634f * fabsf(h)));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.0f + t));
  return fmaf(l, 0.006931471805599453f, fmaxf(h, 0.0f));
}

// Column e of the positional encoding of point x:
// [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...].
__device__ __forceinline__ float pe_value(const float* x, int e) {
  if (e < 3) return x[e];
  const int k = (e - 3) / 6, r = (e - 3) % 6;
  const float v = x[r % 3] * (float)(1 << k);
  return r < 3 ? sinf(v) : cosf(v);
}

// Byte offset of (row, col) in an A operand: K chunks of TILE_P rows of
// 128 bytes, whose 16-byte units are swizzled by row % 8.
__device__ __forceinline__ uint32_t a_offset(int row, int col) {
  return (col >> 6) * A_CHUNK_BYTES + row * 128
         + ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// Writes v0, v1 (columns col, col + 1; col even) of a row as hi and lo.
__device__ __forceinline__ void store_split(char* a_hi, char* a_lo, int row,
                                            int col, float v0, float v1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  const float2 h = __bfloat1622float2(hi);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v0 - h.x, v1 - h.y);
  const uint32_t off = a_offset(row, col);
  *reinterpret_cast<__nv_bfloat162*>(a_hi + off) = hi;
  *reinterpret_cast<__nv_bfloat162*>(a_lo + off) = lo;
}

// Writes v at (row, col) as hi and lo.
__device__ __forceinline__ void store_split1(char* a_hi, char* a_lo, int row,
                                             int col, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
  const uint32_t off = a_offset(row, col);
  *reinterpret_cast<__nv_bfloat16*>(a_hi + off) = hi;
  *reinterpret_cast<__nv_bfloat16*>(a_lo + off) = lo;
}

// x rounded to nearest (even) bf16, for finite x, on the integer units.
__device__ __forceinline__ float bf16r(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// lo and hi rounded to nearest (even) bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The bf16 values of a packed pair as float32.
__device__ __forceinline__ float lo_f(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float hi_f(uint32_t bits) {
  return __uint_as_float(bits & 0xFFFF0000u);
}

// softplus(100 h) / 100 of h = bf16(z) for a pair z0, z1, each op of
// jax.nn.softplus's form rounded to bf16 as JAX's (and torch's) bf16 ops
// round their float32 result, as bf16 bits packed (z0's in the low
// half). Inside the band 2^-16 <= |h| < 1 it is the table of that
// function (act_bf16_table in ops/fused_sdf.py): entry 1 + 2 (m - ACT_LO)
// + sign for |h|'s bits m, so that rotating h's bits left by one and
// clamping indexes it; entry 0, the value below the band (h = 0's);
// entry 2 ACT_SPAN + 1, the sentinel 0x8000 above it, where the closed
// form max(bf16(bf16(100 h) * 0.01f), 0) takes over: there exp(-|100 h|)
// is past every rounding, so the function is bf16(100 h) / 100 for h >= 1
// and 0 for h <= -1 (s / 100 as s * 0.01f rounds as the division for
// every bf16 s: tests/test_torch_fused_sdf.py). Both halves at once in
// 16-bit lanes; no MUFU operation. chip_smoke.py checks the whole
// function over every bf16 input (fused_sdf_act_bf16).
__device__ __forceinline__ uint32_t act2_bf16(float z0, float z1,
                                              const uint16_t* tab) {
  const uint32_t h = pack_rn(z0, z1);
  // The closed form above the band.
  uint32_t z, big;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(z) : "r"(h), "r"(0x42C842C8u));
  asm("max.bf16x2 %0, %1, %2;"
      : "=r"(big) : "r"(pack_rn(lo_f(z) * 0.01f, hi_f(z) * 0.01f)), "r"(0u));
  // The table's index in each half: 2 |h| + sign, from 2 ACT_LO - 1 on,
  // clamped at the sentinel.
  const uint32_t rot = ((h << 1) & 0xFFFEFFFEu) | ((h >> 15) & 0x00010001u);
  const uint32_t lo = (2 * ACT_LO - 1) * 0x00010001u;
  uint32_t t;
  asm("max.u16x2 %0, %1, %2;" : "=r"(t) : "r"(rot), "r"(lo));
  asm("min.u16x2 %0, %1, %2;"
      : "=r"(t) : "r"(t - lo), "r"((2 * ACT_SPAN + 1) * 0x00010001u));
  t <<= 1;   // byte offsets: no half reaches bit 15
  const char* base = reinterpret_cast<const char*>(tab);
  const uint32_t r = __byte_perm(
      *reinterpret_cast<const uint16_t*>(base + (t & 0xFFFFu)),
      *reinterpret_cast<const uint16_t*>(base + (t >> 16)), 0x5410);
  // Each half's sign bit, set only by the sentinel, across its half.
  uint32_t sentinel;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(sentinel) : "r"(r), "r"(0u), "r"(0xBB99u));
  return (r & ~sentinel) | (big & sentinel);
}

// act2_bf16 elementwise (fused_sdf_act_bf16), the table in shared memory.
__global__ void act_bf16_kernel(const float* z, float* out, int n,
                                const uint16_t* table) {
  __shared__ __align__(16) uint16_t tab[ACT_TABLE_BYTES / 2];
  for (int i = threadIdx.x; i < ACT_TABLE_BYTES / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(tab)[i] = reinterpret_cast<const uint4*>(table)[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = lo_f(act2_bf16(z[i], 0.0f, tab));
}

// The bfloat16 mode's activations of a pair as float32: with bf16
// activations (kAct) act2_bf16's bf16 values; else softplus100, which
// the next operand's store rounds.
template <bool kAct>
__device__ __forceinline__ void act2(float z0, float z1, const uint16_t* tab,
                                     float& f0, float& f1) {
  if constexpr (kAct) {
    const uint32_t a = act2_bf16(z0, z1, tab);
    f0 = lo_f(a);
    f1 = hi_f(a);
  } else {
    f0 = softplus100(z0);
    f1 = softplus100(z1);
  }
}

// An encoding value p handed on in the bfloat16 mode: p * scale rounded
// to bf16 (with bf16 activations, p rounded first).
template <bool kAct>
__device__ __forceinline__ float pe_hand_on(float p, float scale) {
  if constexpr (kAct) p = bf16r(p);
  return bf16r(p * scale);
}

// Writes the positional encoding of rows row0 .. row0 + 63 at columns
// col0 .. col0 + 3 (1 + 2 multires) - 1 as hi and lo, thread t of 128: x,
// then one sincosf for each octave and coordinate.
__device__ __forceinline__ void write_pe(char* a_hi, char* a_lo,
                                         const float* xyz, int row0, int t,
                                         int col0, int multires) {
  const int items = 3 + 3 * multires;
  for (int i = t; i < 64 * items; i += 128) {
    const int r = i / items, q = i - r * items;
    const float* x = xyz + (row0 + r) * 3;
    if (q < 3) {
      store_split1(a_hi, a_lo, row0 + r, col0 + q, x[q]);
    } else {
      const int k = (q - 3) / 3, d = q - 3 - 3 * k;
      float sv, cv;
      sincosf(x[d] * (float)(1 << k), &sv, &cv);
      store_split1(a_hi, a_lo, row0 + r, col0 + 3 + 6 * k + d, sv);
      store_split1(a_hi, a_lo, row0 + r, col0 + 6 + 6 * k + d, cv);
    }
  }
}

// The same encoding in float32 for rows row0 .. row0 + 63, row-major
// with d_pe columns, thread t of 128.
__device__ __forceinline__ void encode_rows(float* pe, const float* xyz,
                                            int row0, int t, int multires) {
  const int items = 3 + 3 * multires, d_pe = 3 + 6 * multires;
  for (int i = row0 * items + t; i < (row0 + 64) * items; i += 128) {
    const int r = i / items, q = i - r * items;
    const float* x = xyz + r * 3;
    if (q < 3) {
      pe[r * d_pe + q] = x[q];
    } else {
      const int k = (q - 3) / 3, d = q - 3 - 3 * k;
      sincosf(x[d] * (float)(1 << k), &pe[r * d_pe + 3 + 6 * k + d],
              &pe[r * d_pe + 6 + 6 * k + d]);
    }
  }
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
}

// The bfloat16 mode's turns on the tensor cores: warpgroup wg waits for
// its turn (named barrier 3 + wg, with the other group's arrival) and
// hands the next turn to the other group.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" :: "r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" :: "r"(4 - wg) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The SDF layer's output for rows r0 and r0 + 8 from the four lanes
// that hold them: s0, s1 their partial dot products with the SDF
// column; the encoding's part when the skip junction feeds the SDF
// layer (pe_hand: how an encoding value is handed on), the bias, the
// clamp.
template <typename PeHand>
__device__ __forceinline__ void write_sdf(float s0, float s1, int lane,
                                          int r0, int p0, int n_pts,
                                          const float* xyz,
                                          const float* w_sdf, bool skip_next,
                                          const SdfMeta& meta, float* out,
                                          PeHand pe_hand) {
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  if ((lane & 3) == 0) {
    const float* x0 = xyz + r0 * 3;
    const float* x1 = xyz + (r0 + 8) * 3;
    if (skip_next) {
      // The SDF layer's own input ends in the encoding: its weights for
      // it follow the SDF column.
      const float* w_pe = w_sdf + WIDTH;
      for (int e = 0; e < meta.d_pe; ++e) {
        s0 = fmaf(pe_hand(pe_value(x0, e)), w_pe[e], s0);
        s1 = fmaf(pe_hand(pe_value(x1, e)), w_pe[e], s1);
      }
    }
    const float b_sdf = w_sdf[WIDTH + KCHUNK];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (p0 + row < n_pts) {
        const float* x = h ? x1 : x0;
        float sdf = (h ? s1 : s0) + b_sdf;
        if (meta.bounding_sphere > 0.0f) {
          const float r = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
          sdf = fminf(sdf, meta.sphere_scale * (meta.bounding_sphere - r));
        }
        out[p0 + row] = sdf;
      }
    }
  }
}

// ---- the kernels ------------------------------------------------------------

#ifdef FUSED_SDF_TRACE
// Cycle stamps of block FUSED_SDF_TRACE (in the bfloat16 mode its first
// tile), for each consumer warpgroup:
// [0] its first layer's input written, [1 + 2l] layer l's products done
// (in the bfloat16 mode including the wait for its turn), [2 + 2l]
// layer l's epilogue done (for the last hidden layer: the SDF written).
// Read by fused_sdf_trace(); see
// s_volsdf_tpu_torch/tools/time_fused_sdf.py --trace.
__device__ long long fused_sdf_trace_buf[2][2 * MAX_LAYERS + 1];
// The bfloat16 mode's waits inside each layer's products, for each
// consumer warpgroup: [l][0] its turn taken, [l][1] the layer's first
// stage in the ring, [l][2] its last (read by fused_sdf_trace_waits()).
__device__ long long fused_sdf_wait_buf[2][MAX_LAYERS][3];
#define TRACE(i)                                                     \
  if (blockIdx.x == FUSED_SDF_TRACE && traced && (tid & 127) == 0)   \
    fused_sdf_trace_buf[wg][i] = clock64()
#define TRACE_WAIT(l, i)                                             \
  if (blockIdx.x == FUSED_SDF_TRACE && traced && (tid & 127) == 0)   \
    fused_sdf_wait_buf[wg][l][i] = clock64()
#else
#define TRACE(i)
#define TRACE_WAIT(l, i)
#endif

// The float32 mode: the bf16 x 3 split, the two consumer warpgroups in
// step on one 3-stage ring.
__global__ void __launch_bounds__(N_THREADS, 1)
fused_sdf_kernel(const float* __restrict__ pts, const char* __restrict__ wts,
                 const float* __restrict__ vec, float* __restrict__ out,
                 int n_pts, int vec_stride, SdfMeta meta) {
  extern __shared__ char smem_raw[];
  // This block's scene: its points, weight stream, vector and outputs.
  pts += (size_t)blockIdx.y * n_pts * 3;
  wts += (size_t)blockIdx.y * meta.n_stages * STAGE_BYTES;
  vec += (size_t)blockIdx.y * vec_stride;
  out += (size_t)blockIdx.y * n_pts;
  const uint32_t raw = smem_u32(smem_raw);
  char* smem = smem_raw + ((SMEM_ALIGN - (raw & (SMEM_ALIGN - 1)))
                           & (SMEM_ALIGN - 1));
  char* a_hi = smem;                          // A operands, 128 x 256 bf16
  char* a_lo = smem + A_BYTES;
  char* ring = smem + 2 * A_BYTES;            // STAGES weight stages
  float* xyz = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(xyz + TILE_P * 3);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // The warp's index, broadcast from lane 0 so that the compiler knows
  // it is the same across the warp: the role branch below is then not
  // divergent, and ptxas keeps the wgmma chain asynchronous.
  const int warp_idx = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int p0 = blockIdx.x * TILE_P;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);              // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), N_CONSUMER);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < TILE_P * 3; i += N_THREADS) {
    const long long g = (long long)p0 * 3 + i;
    xyz[i] = g < (long long)n_pts * 3 ? pts[g] : 0.0f;
  }
  __syncthreads();

  if (warp_idx >= N_CONSUMER / 32) {
    // Producer warpgroup: one thread streams the weight stages through
    // the ring; the group gives its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == N_CONSUMER) {
      for (int s = 0; s < meta.n_stages; ++s) {
        const int slot = s % STAGES;
        mbar_wait(smem_u32(&empty[slot]), ((s / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(smem_u32(&full[slot]), STAGE_BYTES);
        bulk_load(smem_u32(ring + slot * STAGE_BYTES),
                  wts + (size_t)s * STAGE_BYTES, STAGE_BYTES,
                  smem_u32(&full[slot]));
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp_idx >> 2;
    const int lane = tid & 31;
    // The accumulator's rows and column pair (wgmma's m64nN layout):
    // acc[4j], acc[4j + 1] are row r0, columns 8j + cq and 8j + cq + 1;
    // acc[4j + 2], acc[4j + 3] the same columns of row r0 + 8.
    const int r0 = wg * 64 + (warp_idx & 3) * 16 + (lane >> 2);
    const int cq = (lane & 3) * 2;
    const int multires = (meta.d_pe - 3) / 6;
    [[maybe_unused]] constexpr bool traced = true;   // TRACE's condition

    // Layer 0's input: the positional encoding, zero-padded to one chunk.
    const int pad = KCHUNK - meta.d_pe;
    for (int i = tid & 127; i < 64 * pad; i += 128) {
      const int r = i / pad;
      store_split1(a_hi, a_lo, wg * 64 + r, meta.d_pe + i - r * pad, 0.0f);
    }
    write_pe(a_hi, a_lo, xyz, wg * 64, tid & 127, 0, multires);
    fence_async_smem();
    wg_sync(wg);
    TRACE(0);

    const uint64_t desc_a_hi = sw128_desc(smem_u32(a_hi + wg * 64 * 128));
    const uint64_t desc_a_lo = sw128_desc(smem_u32(a_lo + wg * 64 * 128));
    const uint64_t desc_ring = sw128_desc(smem_u32(ring));
    float acc[128];
    int s = 0;   // the weight stream's stage
    for (int l = 0; l < meta.n_hidden; ++l) {
      // The accumulator starts at the bias.
      const float* bias = vec + l * WIDTH;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 b =
            __ldg(reinterpret_cast<const float2*>(bias + j * 8 + cq));
        acc[4 * j] = acc[4 * j + 2] = b.x;
        acc[4 * j + 1] = acc[4 * j + 3] = b.y;
      }
      fence_acc(acc);
      for (int c = 0; c < meta.chunks[l]; ++c) {
        // One K chunk is two stages; advancing a descriptor by 2 moves
        // 32 bytes (16 bf16) along K inside the swizzled rows.
        const uint64_t ah = desc_a_hi + (uint64_t)(c * (A_CHUNK_BYTES >> 4));
        const uint64_t al = desc_a_lo + (uint64_t)(c * (A_CHUNK_BYTES >> 4));
        // W_hi: acc += A_hi W_hi + A_lo W_hi.
        int slot = s % STAGES;
        mbar_wait(smem_u32(&full[slot]), (s / STAGES) & 1);
        wgmma_fence();
        uint64_t b = desc_ring + (uint64_t)(slot * (STAGE_BYTES >> 4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16(acc, ah + 2 * kk, b + 2 * kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16(acc, al + 2 * kk, b + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();   // the previous chunk's W_lo stage is done
        if (c > 0) mbar_arrive(smem_u32(&empty[(s - 1) % STAGES]));
        ++s;
        // W_lo: acc += A_hi W_lo.
        slot = s % STAGES;
        mbar_wait(smem_u32(&full[slot]), (s / STAGES) & 1);
        wgmma_fence();
        b = desc_ring + (uint64_t)(slot * (STAGE_BYTES >> 4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16(acc, ah + 2 * kk, b + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();   // this chunk's W_hi stage is done
        mbar_arrive(smem_u32(&empty[(s - 1) % STAGES]));
        ++s;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(smem_u32(&empty[(s - 1) % STAGES]));
      TRACE(1 + 2 * l);

      if (l + 1 < meta.n_hidden) {
        // Softplus and split: the next layer's A operand.
        wg_sync(wg);   // every warp of the group has read this layer's A
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = j * 8 + cq;
          store_split(a_hi, a_lo, r0, col, softplus100(acc[4 * j]),
                      softplus100(acc[4 * j + 1]));
          store_split(a_hi, a_lo, r0 + 8, col, softplus100(acc[4 * j + 2]),
                      softplus100(acc[4 * j + 3]));
        }
        if (l + 1 == meta.skip) {
          // The skip junction: the encoding over columns pe_col onwards
          // (the previous layer's product is zero-padded there).
          wg_sync(wg);
          write_pe(a_hi, a_lo, xyz, wg * 64, tid & 127, meta.pe_col,
                   multires);
        }
        fence_async_smem();
        wg_sync(wg);
      } else {
        // The SDF layer: each row's dot product with the SDF column,
        // over the four threads that hold the row.
        const float* w_sdf = vec + meta.n_hidden * WIDTH;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 w =
              __ldg(reinterpret_cast<const float2*>(w_sdf + j * 8 + cq));
          s0 = fmaf(softplus100(acc[4 * j]), w.x,
                    fmaf(softplus100(acc[4 * j + 1]), w.y, s0));
          s1 = fmaf(softplus100(acc[4 * j + 2]), w.x,
                    fmaf(softplus100(acc[4 * j + 3]), w.y, s1));
        }
        write_sdf(s0, s1, lane, r0, p0, n_pts, xyz, w_sdf,
                  l + 1 == meta.skip, meta, out, [](float p) { return p; });
      }
      TRACE(2 + 2 * l);
    }
  }
}

// The bfloat16 mode, with bf16 activations when kAct: a persistent grid
// of clusters of 2 blocks, cluster c taking pairs of tiles c, c + C, ...
// (C clusters; pair q of scene q / pairs, tiles 2 (q % pairs) and the
// next, one a block); each weight stage shared by the pair (multicast),
// a ring of n_ring stages that runs on from tile to tile, each layer's
// A operand in registers, the two consumer warpgroups taking turns on
// the tensor cores (see the header). `table`: the activation's band
// (act2_bf16), read when kAct.
template <bool kAct>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(N_THREADS, 1)
fused_sdf_bf16_kernel(const float* __restrict__ pts,
                      const char* __restrict__ wts,
                      const float* __restrict__ vec,
                      const uint16_t* __restrict__ table,
                      float* __restrict__ out, int n_pts, int n_scenes,
                      int vec_stride, int n_ring, SdfMeta meta) {
  extern __shared__ __align__(16) char smem_raw[];
  // The table first, then the ring at the swizzle's alignment: the same
  // offsets in both blocks of the cluster, so the multicast copies and
  // the remote arrivals address the other block's ring and barriers by
  // this block's own.
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem_raw);
  const uint32_t raw = smem_u32(smem_raw + ACT_TABLE_BYTES);
  char* ring = smem_raw + ACT_TABLE_BYTES
               + ((SMEM_ALIGN - (raw & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
  float* pe = reinterpret_cast<float*>(ring + n_ring * STAGE_BYTES);
  float* xyz = pe + TILE_P * meta.d_pe;       // the encoding, (TILE_P, d_pe)
  uint64_t* full = reinterpret_cast<uint64_t*>(xyz + TILE_P * 3);
  uint64_t* empty = full + MAX_RING;

  const int tid = threadIdx.x;
  const int warp_idx = __shfl_sync(0xffffffffu, tid / 32, 0);
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  const int pairs = ((n_pts + TILE_P - 1) / TILE_P + CLUSTER - 1) / CLUSTER;
  const int n_pairs = pairs * n_scenes;
  if (tid == 0) {
    for (int s = 0; s < n_ring; ++s) {
      mbar_init(smem_u32(&full[s]), 1);   // this block's producer's expect_tx
      // One arrival from each consumer warpgroup of both blocks.
      mbar_init(smem_u32(&empty[s]), CLUSTER * N_CONSUMER / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kAct) {
    for (int i = tid; i < ACT_TABLE_BYTES / 16; i += N_THREADS)
      reinterpret_cast<uint4*>(tab)[i] =
          __ldg(reinterpret_cast<const uint4*>(table) + i);
  }
  __syncthreads();
  cluster_sync();   // both blocks' barriers are initialised

  if (warp_idx >= N_CONSUMER / 32) {
    // Producer warpgroup: one thread copies its half of each stage of
    // each pair's scene into both blocks' rings once both blocks'
    // consumers have released the slot; the group gives its registers
    // to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == N_CONSUMER) {
      int g = 0;   // stages copied so far, over all pairs
      for (int q = cluster; q < n_pairs; q += clusters) {
        const char* w = wts + (size_t)(q / pairs) * meta.n_stages * STAGE_BYTES;
        for (int s = 0; s < meta.n_stages; ++s, ++g) {
          const int slot = g % n_ring;
          mbar_wait_bounded(smem_u32(&empty[slot]), ((g / n_ring) & 1) ^ 1);
          mbar_arrive_expect_tx(smem_u32(&full[slot]), STAGE_BYTES);
          bulk_load_multicast(
              smem_u32(ring + slot * STAGE_BYTES + rank * HALF_STAGE_BYTES),
              w + (size_t)s * STAGE_BYTES + rank * HALF_STAGE_BYTES,
              HALF_STAGE_BYTES, smem_u32(&full[slot]), (1u << CLUSTER) - 1);
        }
      }
    }
    cluster_sync();   // no block leaves while the other may still write
  } else {
    // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp_idx >> 2;
    const int lane = tid & 31;
    const int multires = (meta.d_pe - 3) / 6;
    // The accumulator's rows and column pair (wgmma's m64nN layout):
    // acc[4j], acc[4j + 1] are row r0, columns 8j + cq and 8j + cq + 1;
    // acc[4j + 2], acc[4j + 3] the same columns of row r0 + 8. The A
    // operand's register fragment has the same layout, packed in pairs:
    // a[2j] holds row r0's pair of columns 8j + cq, a[2j + 1] row r0 + 8's,
    // so a[16c .. 16c + 15] is K chunk c and a[16c + 4kk ..] its k16 step kk.
    const int r0 = wg * 64 + (warp_idx & 3) * 16 + (lane >> 2);
    const int cq = (lane & 3) * 2;
    // The group is done with a stage: one arrival on each block's
    // barrier, from lane 0 of warp r of the group for block r (a wgmma
    // waited for in one warp of the group is done in all four).
    auto release = [&](int slot) {
      if (lane == 0 && (warp_idx & 3) < CLUSTER)
        mbar_arrive_cluster(smem_u32(&empty[slot]), warp_idx & 3);
    };
    // Column col of row's input at the skip junction (scale: its
    // 1/sqrt(2)): the encoding's value there, else v, the activation.
    auto junction = [&](float v, int row, int col, float scale) {
      const int e = col - meta.pe_col;
      return e >= 0 && e < meta.d_pe
                 ? pe_hand_on<kAct>(pe[row * meta.d_pe + e], scale) : v;
    };
    const uint64_t desc_ring = sw128_desc(smem_u32(ring));
    uint32_t a[4 * WIDTH / 16];
    float acc[128];
    int s = 0;   // stages consumed so far, over all pairs
    if (wg == 1) turn_pass(wg);   // the first turn is warpgroup 0's

    for (int q = cluster; q < n_pairs; q += clusters) {
      // This pair's scene: its points, vector and outputs; this block's
      // tile of the pair.
      [[maybe_unused]] const bool traced = q == cluster;   // TRACE's: the first
      const bool last_pair = q + clusters >= n_pairs;
      const int scene = q / pairs;
      const int p0 = ((q % pairs) * CLUSTER + rank) * TILE_P;
      const float* spts = pts + (size_t)scene * n_pts * 3;
      const float* svec = vec + (size_t)scene * vec_stride;
      float* sout = out + (size_t)scene * n_pts;
      // The group's rows of the tile and their encoding (the group's
      // own: the other group may still be on the previous tile), once
      // the group is done with the previous tile's.
      wg_sync(wg);
      for (int i = wg * 64 * 3 + (tid & 127); i < (wg + 1) * 64 * 3; i += 128) {
        const long long g = (long long)p0 * 3 + i;
        xyz[i] = g < (long long)n_pts * 3 ? spts[g] : 0.0f;
      }
      wg_sync(wg);
      encode_rows(pe, xyz, wg * 64, tid & 127, multires);
      wg_sync(wg);

      // Layer 0's input: the encoding, zero-padded to one K chunk.
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h, col = j * 8 + cq;
          float v[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            v[i] = col + i < meta.d_pe
                       ? pe_hand_on<kAct>(pe[row * meta.d_pe + col + i], 1.0f)
                       : 0.0f;
          a[2 * j + h] = pack_rn(v[0], v[1]);
        }
      }
      TRACE(0);

      for (int l = 0; l < meta.n_hidden; ++l) {
        // The accumulator starts at the bias.
        const float* bias = svec + l * WIDTH;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 b =
              __ldg(reinterpret_cast<const float2*>(bias + j * 8 + cq));
          acc[4 * j] = acc[4 * j + 2] = b.x;
          acc[4 * j + 1] = acc[4 * j + 3] = b.y;
        }
        fence_acc(acc);
        turn_wait(wg);
        TRACE_WAIT(l, 0);
        const int chunks = meta.chunks[l];
        // Once the layer's last chunk is issued, the other group's turn
        // (none after warpgroup 1's last layer).
        const bool pass = wg == 0 || !last_pair || l + 1 < meta.n_hidden;
#pragma unroll
        for (int c = 0; c < MAX_CHUNKS; ++c) {
          if (c < chunks) {
            // acc += A W_hi over one K chunk (one stage); advancing the
            // descriptor by 2 moves 32 bytes (16 bf16) along K inside the
            // swizzled rows.
            const int slot = s % n_ring;
            mbar_wait(smem_u32(&full[slot]), (s / n_ring) & 1);
            if (c == 0) TRACE_WAIT(l, 1);
            if (c + 1 == chunks) TRACE_WAIT(l, 2);
            wgmma_fence();
            const uint64_t b =
                desc_ring + (uint64_t)(slot * (STAGE_BYTES >> 4));
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_m64n256k16(acc, a + 16 * c + 4 * kk, b + 2 * kk);
            wgmma_commit();
            if (c + 1 == chunks && pass) turn_pass(wg);
            wgmma_wait<1>();   // the previous chunk's stage is done
            if (c > 0) release((s - 1) % n_ring);
            ++s;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        fence_a(a, 4 * WIDTH / 16);
        release((s - 1) % n_ring);
        TRACE(1 + 2 * l);

        const bool skip_next = (l + 1 == meta.skip);
        const float scale = skip_next ? meta.skip_scale : 1.0f;
        if (l + 1 < meta.n_hidden) {
          // The activation, rounded to bf16: the next layer's A operand.
          if (skip_next) {
            // ... times the junction's scale, then the encoding over
            // columns pe_col onwards (the layer's product is zero-padded
            // there): only the column groups that hold some of it.
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              float f[4];
              act2<kAct>(acc[4 * j], acc[4 * j + 1], tab, f[0], f[1]);
              act2<kAct>(acc[4 * j + 2], acc[4 * j + 3], tab, f[2], f[3]);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                a[2 * j + h] = pack_rn(f[2 * h] * scale, f[2 * h + 1] * scale);
            }
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              if (j * 8 + 8 > meta.pe_col && j * 8 < meta.pe_col + meta.d_pe) {
                const int col = j * 8 + cq;
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  a[2 * j + h] = pack_rn(
                      junction(lo_f(a[2 * j + h]), r0 + 8 * h, col, scale),
                      junction(hi_f(a[2 * j + h]), r0 + 8 * h, col + 1,
                               scale));
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              if constexpr (kAct) {
                a[2 * j] = act2_bf16(acc[4 * j], acc[4 * j + 1], tab);
                a[2 * j + 1] = act2_bf16(acc[4 * j + 2], acc[4 * j + 3], tab);
              } else {
                a[2 * j] = pack_rn(softplus100(acc[4 * j]),
                                   softplus100(acc[4 * j + 1]));
                a[2 * j + 1] = pack_rn(softplus100(acc[4 * j + 2]),
                                       softplus100(acc[4 * j + 3]));
              }
            }
          }
        } else {
          // The SDF layer: each row's dot product with the SDF column,
          // over the four threads that hold the row; bf16 operands, so
          // every product is exact in f32.
          const float* w_sdf = svec + meta.n_hidden * WIDTH;
          float s0 = 0.0f, s1 = 0.0f;
          // With bf16 activations and no junction here the activations
          // are the operands already; else act * scale rounded to bf16.
          if (kAct && !skip_next) {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const float2 w =
                  __ldg(reinterpret_cast<const float2*>(w_sdf + j * 8 + cq));
              float f0, f1, f2, f3;
              act2<kAct>(acc[4 * j], acc[4 * j + 1], tab, f0, f1);
              act2<kAct>(acc[4 * j + 2], acc[4 * j + 3], tab, f2, f3);
              s0 = fmaf(f0, w.x, fmaf(f1, w.y, s0));
              s1 = fmaf(f2, w.x, fmaf(f3, w.y, s1));
            }
          } else {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const float2 w =
                  __ldg(reinterpret_cast<const float2*>(w_sdf + j * 8 + cq));
              float f0, f1, f2, f3;
              act2<kAct>(acc[4 * j], acc[4 * j + 1], tab, f0, f1);
              act2<kAct>(acc[4 * j + 2], acc[4 * j + 3], tab, f2, f3);
              s0 = fmaf(bf16r(f0 * scale), w.x,
                        fmaf(bf16r(f1 * scale), w.y, s0));
              s1 = fmaf(bf16r(f2 * scale), w.x,
                        fmaf(bf16r(f3 * scale), w.y, s1));
            }
          }
          write_sdf(s0, s1, lane, r0, p0, n_pts, xyz, w_sdf, skip_next, meta,
                    sout,
                    [scale](float p) { return pe_hand_on<kAct>(p, scale); });
        }
        TRACE(2 + 2 * l);
      }
    }
    cluster_sync<true>();   // no block leaves while the other may arrive
  }
}

__host__ __device__ inline int multires_of(const SdfMeta& meta) {
  return (meta.d_pe - 3) / 6;
}

// Dynamic shared memory of the bfloat16 mode's block with a ring of
// n_ring stages and an encoding of d_pe columns.
static size_t bf16_smem_bytes(int n_ring, int d_pe) {
  return ACT_TABLE_BYTES + SMEM_ALIGN + (size_t)n_ring * STAGE_BYTES
         + (size_t)TILE_P * d_pe * 4 + TILE_P * 3 * 4 + 2 * MAX_RING * 8;
}

extern "C" {

// Dynamic shared memory of a block of mode `mode` (SdfMeta.mode) with an
// encoding of d_pe columns: the bfloat16 mode's ring takes as many
// stages (up to MAX_RING) as a block's shared memory holds.
size_t fused_sdf_smem_bytes(int mode, int d_pe) {
  if (!mode) return SMEM_BYTES;
  static int optin[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < MAX_DEVICES && !optin[dev])
    cudaDeviceGetAttribute(&optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int limit = dev < MAX_DEVICES ? optin[dev] : 0;
  int n_ring = MAX_RING;
  while (n_ring > MAX_CHUNKS && bf16_smem_bytes(n_ring, d_pe) > (size_t)limit)
    --n_ring;
  return bf16_smem_bytes(n_ring, d_pe);
}

// Launches the kernel of meta.mode and meta.act_bf16 on `stream` for
// n_scenes scenes: points (n_scenes, n_pts, 3), weight streams of
// meta.n_stages stages each, vectors vec_stride floats apart (even),
// outputs (n_scenes, n_pts); `table`, the bf16 activation's band
// (act_bf16_table; read with bf16 activations, else may be null).
// Returns cudaGetLastError() (0 on success).
int fused_sdf_forward_scenes(const float* pts, const void* wts,
                             const float* vec, const void* table, float* out,
                             int n_pts, int n_scenes, int vec_stride,
                             SdfMeta meta, cudaStream_t stream) {
  if (n_scenes > 1 && (vec_stride & 1)) return (int)cudaErrorInvalidValue;
  const int tiles = (n_pts + TILE_P - 1) / TILE_P;
  const char* w = static_cast<const char*>(wts);
  if (!meta.mode) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_sdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (n_pts > 0 && n_scenes > 0)
      fused_sdf_kernel<<<dim3(tiles, n_scenes), N_THREADS, SMEM_BYTES,
                         stream>>>(pts, w, vec, out, n_pts, vec_stride, meta);
    return (int)cudaGetLastError();
  }
  if (meta.act_bf16 && !table) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const char*, const float*, const uint16_t*,
                 float*, int, int, int, int, SdfMeta) =
      meta.act_bf16 ? fused_sdf_bf16_kernel<true>
                    : fused_sdf_bf16_kernel<false>;
  const size_t smem = fused_sdf_smem_bytes(1, meta.d_pe);
  int n_ring = MAX_RING;
  while (bf16_smem_bytes(n_ring, meta.d_pe) > smem) --n_ring;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_pts <= 0 || n_scenes <= 0) return (int)cudaGetLastError();
  // As many clusters as the card holds at once (asked once a device,
  // kernel and encoding width), each walking its pairs of tiles.
  static int fits[MAX_DEVICES][2][MAX_MULTIRES + 1] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int* fit = &fits[dev][meta.act_bf16 != 0][multires_of(meta)];
  if (!*fit) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(CLUSTER, 1, 1);
    config.blockDim = dim3(N_THREADS, 1, 1);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    err = cudaOccupancyMaxActiveClusters(fit, (void*)kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (*fit < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long pairs =
      (long long)((tiles + CLUSTER - 1) / CLUSTER) * n_scenes;
  const int clusters = (int)(pairs < *fit ? pairs : *fit);
  kernel<<<clusters * CLUSTER, N_THREADS, smem, stream>>>(
      pts, w, vec, static_cast<const uint16_t*>(table), out, n_pts,
      n_scenes, vec_stride, n_ring, meta);
  return (int)cudaGetLastError();
}

// One scene: points (n_pts, 3).
int fused_sdf_forward(const float* pts, const void* wts, const float* vec,
                      const void* table, float* out, int n_pts, SdfMeta meta,
                      cudaStream_t stream) {
  return fused_sdf_forward_scenes(pts, wts, vec, table, out, n_pts, 1, 0,
                                  meta, stream);
}

// act2_bf16 (the bfloat16 mode's activation of a hidden unit, as the SDF
// kernel computes it) of n float32 values, on `stream`, with `table`
// (act_bf16_table): the check of it over every bf16 input. Returns
// cudaGetLastError().
int fused_sdf_act_bf16(const float* z, float* out, int n, const void* table,
                       cudaStream_t stream) {
  if (!table) return (int)cudaErrorInvalidValue;
  if (n > 0)
    act_bf16_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        z, out, n, static_cast<const uint16_t*>(table));
  return (int)cudaGetLastError();
}

const char* fused_sdf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef FUSED_SDF_TRACE
// Copies the traced block's cycle stamps (2 x 33 long longs) to host.
int fused_sdf_trace(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, fused_sdf_trace_buf,
                                   sizeof(fused_sdf_trace_buf));
}

// ... and the bfloat16 mode's waits (2 x 16 x 3 long longs).
int fused_sdf_trace_waits(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, fused_sdf_wait_buf,
                                   sizeof(fused_sdf_wait_buf));
}
#endif

}  // extern "C"
