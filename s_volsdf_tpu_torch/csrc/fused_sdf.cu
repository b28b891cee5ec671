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
// JAX training step's default. The same kernel, instantiated with
// kSplit = false:
//   * every layer input is rounded to nearest bf16 and each layer is
//     the one product A_hi W_hi (W_hi = bf16(W), rounded to nearest),
//     accumulated in f32 on top of the f32 bias. The pack holds only
//     W_hi, so the ring streams half the bytes, and the epilogue writes
//     only a_hi (a_lo is not read);
//   * with activation_dtype="bfloat16" the pre-activation is rounded to
//     bf16 before the softplus and the softplus after it, as JAX's
//     h.astype(bf16) and its bf16 softplus round (JAX rounds inside the
//     softplus too: the CPU tests hold the two within bf16 units). The
//     roundings inside the epilogue are integer round-to-nearest-even
//     on the bits, off the conversion unit that the softplus's MUFU
//     operations share: with cvt.rn they doubled the epilogue (PERF.md);
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
// x3 mode's. With a third of the products, the epilogue, which the
// x3 mode already does not overlap (32.5% of a block's cycles there),
// likely sets its pace.
//
// The scene axis (fused_sdf_forward_scenes): S scenes' points, weight
// streams and vectors laid out one scene after another, one launch with
// blockIdx.y the scene. Each block moves its pointers to its scene's
// and does what a single launch's block does, so the batched launch
// equals S single launches bit for bit (the lockstep multi-scene step's
// sweep, s_volsdf_tpu_torch/engine/multiscene.py; the counterpart of
// the leading grid axis JAX's batching rule gives a vmapped
// pallas_call).
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
#define STAGES 3
#define STAGE_BYTES (WIDTH * KCHUNK * 2)         // one chunk of W_hi or W_lo
#define A_CHUNK_BYTES (TILE_P * KCHUNK * 2)      // one K chunk of A_hi or A_lo
#define A_BYTES (MAX_CHUNKS * A_CHUNK_BYTES)
#define SMEM_ALIGN 1024                          // the 128-byte swizzle's period
#define SMEM_BYTES (SMEM_ALIGN + 2 * A_BYTES + STAGES * STAGE_BYTES \
                    + TILE_P * 3 * 4 + 2 * STAGES * 8)

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
      :: "r"(bar) : "memory");
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

// The bfloat16 mode's stores: v0, v1 (columns col, col + 1; col even)
// or v, rounded to nearest bf16, into A_hi alone.
__device__ __forceinline__ void store_hi(char* a_hi, int row, int col,
                                         float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(a_hi + a_offset(row, col)) =
      __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store_hi1(char* a_hi, int row, int col,
                                          float v) {
  *reinterpret_cast<__nv_bfloat16*>(a_hi + a_offset(row, col)) =
      __float2bfloat16_rn(v);
}

// x rounded to nearest (even) bf16, for finite x, as cvt.rn.bf16.f32
// rounds it, but on the integer units: the conversion unit is the
// MUFU's, which the softplus already keeps busy.
__device__ __forceinline__ float bf16r(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// The bfloat16 mode's activation of a hidden unit: with bf16 activations
// (kAct) the pre-activation z rounded to bf16 and the softplus too, as
// JAX's h.astype(bf16) and its bf16 softplus round.
template <bool kAct>
__device__ __forceinline__ float act(float z) {
  if constexpr (kAct) return bf16r(softplus100(bf16r(z)));
  return softplus100(z);
}

// The next layer's operand in A_hi is act(z) * scale (scale: 1, or the
// skip junction's 1/sqrt(2)) rounded to bf16: store_hi rounds it. Where
// scale is 1, act's own rounding of the softplus is the store's, and is
// left to it.
template <bool kAct>
__device__ __forceinline__ float act_unrounded(float z) {
  if constexpr (kAct) return softplus100(bf16r(z));
  return softplus100(z);
}

// act(z) * scale rounded to bf16, as a float: the SDF layer's operand.
template <bool kAct>
__device__ __forceinline__ float hand_on(float z, float scale) {
  return bf16r(act<kAct>(z) * scale);
}

// The same for an encoding value p.
template <bool kAct>
__device__ __forceinline__ float pe_hand_on(float p, float scale) {
  if constexpr (kAct) p = bf16r(p);
  return bf16r(p * scale);
}

// Writes v at (row, col) as the mode's operand: hi and lo, or the
// bfloat16 mode's pe_hand_on(v) in A_hi.
template <bool kSplit, bool kAct>
__device__ __forceinline__ void store_pe(char* a_hi, char* a_lo, int row,
                                         int col, float v, float scale) {
  if constexpr (kSplit)
    store_split1(a_hi, a_lo, row, col, v);
  else
    store_hi1(a_hi, row, col, pe_hand_on<kAct>(v, scale));
}

// Writes the positional encoding of rows row0 .. row0 + 63 at columns
// col0 .. col0 + 3 (1 + 2 multires) - 1, thread t of 128: x, then one
// sincosf for each octave and coordinate.
template <bool kSplit, bool kAct>
__device__ __forceinline__ void write_pe(char* a_hi, char* a_lo,
                                         const float* xyz, int row0, int t,
                                         int col0, int multires,
                                         float scale) {
  const int items = 3 + 3 * multires;
  for (int i = t; i < 64 * items; i += 128) {
    const int r = i / items, q = i - r * items;
    const float* x = xyz + (row0 + r) * 3;
    if (q < 3) {
      store_pe<kSplit, kAct>(a_hi, a_lo, row0 + r, col0 + q, x[q], scale);
    } else {
      const int k = (q - 3) / 3, d = q - 3 - 3 * k;
      float sv, cv;
      sincosf(x[d] * (float)(1 << k), &sv, &cv);
      store_pe<kSplit, kAct>(a_hi, a_lo, row0 + r, col0 + 3 + 6 * k + d, sv,
                             scale);
      store_pe<kSplit, kAct>(a_hi, a_lo, row0 + r, col0 + 6 + 6 * k + d, cv,
                             scale);
    }
  }
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- the kernel -------------------------------------------------------------

#ifdef FUSED_SDF_TRACE
// Cycle stamps of block FUSED_SDF_TRACE, for each consumer warpgroup:
// [0] its first layer's input written, [1 + 2l] layer l's products done,
// [2 + 2l] layer l's epilogue done (for the last hidden layer: the SDF
// written). Read by fused_sdf_trace(); see
// s_volsdf_tpu_torch/tools/time_fused_sdf.py --trace.
__device__ long long fused_sdf_trace_buf[2][2 * MAX_LAYERS + 1];
#define TRACE(i)                                                     \
  if (blockIdx.x == FUSED_SDF_TRACE && (tid & 127) == 0)             \
    fused_sdf_trace_buf[wg][i] = clock64()
#else
#define TRACE(i)
#endif

// kSplit: the float32 mode's bf16 x 3 split; else the bfloat16 mode,
// with bf16 activations when kAct.
template <bool kSplit, bool kAct>
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

    // Layer 0's input: the positional encoding, zero-padded to one chunk.
    const int pad = KCHUNK - meta.d_pe;
    for (int i = tid & 127; i < 64 * pad; i += 128) {
      const int r = i / pad;
      store_pe<kSplit, kAct>(a_hi, a_lo, wg * 64 + r, meta.d_pe + i - r * pad,
                             0.0f, 1.0f);
    }
    write_pe<kSplit, kAct>(a_hi, a_lo, xyz, wg * 64, tid & 127, 0, multires,
                           1.0f);
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
        // One K chunk is two stages (one in the bfloat16 mode); advancing
        // a descriptor by 2 moves 32 bytes (16 bf16) along K inside the
        // swizzled rows.
        const uint64_t ah = desc_a_hi + (uint64_t)(c * (A_CHUNK_BYTES >> 4));
        if constexpr (!kSplit) {
          // acc += A_hi W_hi.
          const int slot = s % STAGES;
          mbar_wait(smem_u32(&full[slot]), (s / STAGES) & 1);
          wgmma_fence();
          const uint64_t b = desc_ring + (uint64_t)(slot * (STAGE_BYTES >> 4));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n256k16(acc, ah + 2 * kk, b + 2 * kk);
          wgmma_commit();
          wgmma_wait<1>();   // the previous chunk's stage is done
          if (c > 0) mbar_arrive(smem_u32(&empty[(s - 1) % STAGES]));
          ++s;
          continue;
        }
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

      const bool skip_next = (l + 1 == meta.skip);
      if (l + 1 < meta.n_hidden) {
        // Softplus and split: the next layer's A operand.
        wg_sync(wg);   // every warp of the group has read this layer's A
        const float scale = skip_next ? meta.skip_scale : 1.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = j * 8 + cq;
          if constexpr (kSplit) {
            store_split(a_hi, a_lo, r0, col, softplus100(acc[4 * j]),
                        softplus100(acc[4 * j + 1]));
            store_split(a_hi, a_lo, r0 + 8, col, softplus100(acc[4 * j + 2]),
                        softplus100(acc[4 * j + 3]));
          } else if (skip_next) {
            store_hi(a_hi, r0, col, act<kAct>(acc[4 * j]) * scale,
                     act<kAct>(acc[4 * j + 1]) * scale);
            store_hi(a_hi, r0 + 8, col, act<kAct>(acc[4 * j + 2]) * scale,
                     act<kAct>(acc[4 * j + 3]) * scale);
          } else {
            store_hi(a_hi, r0, col, act_unrounded<kAct>(acc[4 * j]),
                     act_unrounded<kAct>(acc[4 * j + 1]));
            store_hi(a_hi, r0 + 8, col, act_unrounded<kAct>(acc[4 * j + 2]),
                     act_unrounded<kAct>(acc[4 * j + 3]));
          }
        }
        if (skip_next) {
          // The skip junction: the encoding over columns pe_col onwards
          // (the previous layer's product is zero-padded there).
          wg_sync(wg);
          write_pe<kSplit, kAct>(a_hi, a_lo, xyz, wg * 64, tid & 127,
                                 meta.pe_col, multires, scale);
        }
        fence_async_smem();
        wg_sync(wg);
      } else {
        // The SDF layer: each row's dot product with the SDF column,
        // over the four threads that hold the row.
        const float* w_sdf = vec + meta.n_hidden * WIDTH;
        const float scale = skip_next ? meta.skip_scale : 1.0f;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 w =
              __ldg(reinterpret_cast<const float2*>(w_sdf + j * 8 + cq));
          if constexpr (kSplit) {
            s0 = fmaf(softplus100(acc[4 * j]), w.x,
                      fmaf(softplus100(acc[4 * j + 1]), w.y, s0));
            s1 = fmaf(softplus100(acc[4 * j + 2]), w.x,
                      fmaf(softplus100(acc[4 * j + 3]), w.y, s1));
          } else {
            // bf16 operands: every product is exact in f32.
            s0 = fmaf(hand_on<kAct>(acc[4 * j], scale), w.x,
                      fmaf(hand_on<kAct>(acc[4 * j + 1], scale), w.y, s0));
            s1 = fmaf(hand_on<kAct>(acc[4 * j + 2], scale), w.x,
                      fmaf(hand_on<kAct>(acc[4 * j + 3], scale), w.y, s1));
          }
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if ((lane & 3) == 0) {
          const float* x0 = xyz + r0 * 3;
          const float* x1 = xyz + (r0 + 8) * 3;
          if (skip_next) {
            // The SDF layer's own input ends in the encoding: its
            // weights for it follow the SDF column.
            const float* w_pe = w_sdf + WIDTH;
            for (int e = 0; e < meta.d_pe; ++e) {
              float p0 = pe_value(x0, e), p1 = pe_value(x1, e);
              if constexpr (!kSplit) {
                p0 = pe_hand_on<kAct>(p0, scale);
                p1 = pe_hand_on<kAct>(p1, scale);
              }
              s0 = fmaf(p0, w_pe[e], s0);
              s1 = fmaf(p1, w_pe[e], s1);
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
                const float r =
                    sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
                sdf = fminf(sdf,
                            meta.sphere_scale * (meta.bounding_sphere - r));
              }
              out[p0 + row] = sdf;
            }
          }
        }
      }
      TRACE(2 + 2 * l);
    }
  }
}

extern "C" {

size_t fused_sdf_smem_bytes(void) { return SMEM_BYTES; }

// Launches the instantiation of meta.mode and meta.act_bf16 on
// `stream` for n_scenes scenes: points (n_scenes, n_pts, 3), weight
// streams of meta.n_stages stages each, vectors vec_stride floats apart
// (even), outputs (n_scenes, n_pts). Returns cudaGetLastError() (0 on
// success).
int fused_sdf_forward_scenes(const float* pts, const void* wts,
                             const float* vec, float* out, int n_pts,
                             int n_scenes, int vec_stride, SdfMeta meta,
                             cudaStream_t stream) {
  void (*kernel)(const float*, const char*, const float*, float*, int, int,
                 SdfMeta) =
      !meta.mode ? fused_sdf_kernel<true, false>
      : meta.act_bf16 ? fused_sdf_kernel<false, true>
                      : fused_sdf_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (n_scenes > 1 && (vec_stride & 1)) return (int)cudaErrorInvalidValue;
  if (n_pts > 0 && n_scenes > 0) {
    const dim3 blocks((n_pts + TILE_P - 1) / TILE_P, n_scenes);
    kernel<<<blocks, N_THREADS, SMEM_BYTES, stream>>>(
        pts, static_cast<const char*>(wts), vec, out, n_pts, vec_stride,
        meta);
  }
  return (int)cudaGetLastError();
}

// One scene: points (n_pts, 3).
int fused_sdf_forward(const float* pts, const void* wts, const float* vec,
                      float* out, int n_pts, SdfMeta meta,
                      cudaStream_t stream) {
  return fused_sdf_forward_scenes(pts, wts, vec, out, n_pts, 1, 0, meta,
                                  stream);
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
#endif

}  // extern "C"
