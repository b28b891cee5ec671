// Modulated deformable convolution (DCNv2), stride 1, 3x3 taps, padding
// 1, float32: the deformable conv of TransMVSNet's feature heads.
//
// Replaces s_volsdf_tpu/ops/deform_conv.py:29 `deform_conv2d` (XLA, not
// Pallas: a per-tap lax.scan of a packed-corner gather and a matmul; the
// reference calls torchvision's CUDA kernel, on which the port does not
// depend). For each output pixel p and tap k:
//   1. the sample point is p + (k / 3 - 1, k % 3 - 1) + (dy_k, dx_k), with
//      dy_k = offset[2k], dx_k = offset[2k + 1] (torchvision's reading of
//      the offset conv's first 2K channels);
//   2. x is sampled there bilinearly, a corner outside [0, H) x [0, W)
//      contributing 0 (grid_sample.bilinear_packed_pix's rule), and the
//      sample is scaled by mask[k];
//   3. the Cin samples are contracted with tap k's rows of the
//      (9 * Cin, Cout) weight; the taps are summed and the bias added.
// Layouts are channel-major, a batch of N images in one launch: x (N, 32,
// H, W), offset (N, 18, H, W), mask (N, 9, H, W), out (N, Cout, H, W),
// Cout 8, 16 or 32.
//
// Bound. The contraction is a GEMM, M = pixels, N = Cout, K = 288. At
// float32 accuracy on the tensor cores it takes three TF32 products
// (below): at TransMVSNet's largest launch (1152 x 1536, 32 -> 32) 3 x
// 32.6 GFLOP, 0.198 ms at 495 TFLOP/s. The corner blend (4.1 GFLOP) runs
// on the FP32 pipe beside it; the bytes (x, the 27 offset and mask
// channels and the output once, 0.64 GB) take 0.19 ms at 3.35 TB/s. So
// the tensor cores bound 32 -> 32 and the bytes 32 -> 8.
//
// Design.
// * Contraction on the tensor cores at float32 accuracy ("3xTF32"): each
//   operand a is split into hi = a rounded to TF32 (to nearest, ties
//   away, as cvt.rna.tf32.f32, done on the integer pipe) and lo = a - hi,
//   and mma.sync.m16n8k8 accumulates lo*W_hi + hi*W_lo + hi*W_hi in
//   float32 (about 2^-21 of each product; a single TF32 product keeps
//   2^-11, too coarse for the 1e-5 bar over 288 terms). The weights are
//   split once per block into shared memory, already in the B-fragment
//   order of each lane (one 16-byte load gives a lane b0, b1 hi and lo).
// * A block of 16 warps owns a 16 x 16 output tile, a warp one row of it
//   (one m16 tile), and stages the tile's input window, the tile plus a
//   halo of kHalo = 4 pixels, in shared memory: 24 x 24 pixels x 32
//   channels, each pixel one 128-byte row, loaded 16 bytes (4 pixels of
//   a channel) a lane from the channel-major x into registers and stored
//   a tap later to the pixels' rows (no channel-last copy of x, no
//   transpose pass), zero outside the image, so that a corner outside
//   the image reads 0. Within a row the four channel quads of each half
//   are permuted by the pixel, so that those stores hit 32 banks.
// * Sampling feeds the products from registers: a lane samples exactly
//   the A fragments it holds, 2 pixels x 8 channels a tap (channels
//   4t..4t+3 and 16+4t..16+4t+3 of lane t), two 16-byte loads a corner.
//   Lanes of even and odd groups read opposite halves of their corners'
//   rows in the same instruction, so the 8 lanes of a load phase cover
//   32 distinct banks wherever the corners fall. The window's samples are
//   taken branch-free; a sample whose corners leave the window is then
//   taken again from x in device memory inside the same kernel (with the
//   image-edge rule): 1.1% of the samples at a 2-pixel spread of random
//   offsets, and right for any offset. No barrier separates sampling from
//   products within a tile: the 16 warps interleave them.
// * A persistent grid (one block per SM: 221 KB of shared memory at Cout
//   32) walks the tiles; the next tile's window is filled into the second
//   buffer during the current tile's taps (a ninth of it a tap), and the
//   offsets and mask of the next tap are fetched one tap ahead into
//   registers. One barrier a tile.
//
// What holds it back (PERF.md; tools/time_deform_conv.py --ablate on an
// H100: 1.16 ms in all at 1152 x 1536, 32 -> 32): not the tensor cores
// (without the products it takes as long: they hide behind the
// sampling) but the sampling's instruction stream (0.62 ms: each
// sample's coordinates computed by the 4 lanes that share it, the split,
// the addresses), the window fill (0.13 ms) and what stays when all
// three are gone (0.33 ms, mostly the 16 B a lane that each warp's B
// fragments read from shared memory every k8 step). Tried and measured
// slower there: 8 warps of two m16 tiles, the products
// software-pipelined against the next tap's sampling, and wgmma with A
// from registers (right, but at 255 registers).

#include <cstdint>
#include <cuda_runtime.h>

// Timing builds only (tools/time_deform_conv.py --ablate), bits that
// may be combined: 1 fills no window after the first tile's, 2 skips the
// sampling (constant samples, no offset or mask read), 4 skips the
// contraction (the samples summed on the FP32 pipe instead).
#ifndef DEFORM_CONV_ABLATE
#define DEFORM_CONV_ABLATE 0
#endif

namespace {

constexpr int kTaps = 9;
constexpr int kCin = 32;
constexpr int kTile = 16;                  // output tile kTile x kTile
constexpr int kHalo = 4;                   // window margin on each side
constexpr int kWin = kTile + 2 * kHalo;    // 24: window side
constexpr int kWinFloats = kWin * kWin * kCin;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = kCin / 8;           // k8 steps a tap
constexpr int kFillSteps = kWin * kWin * kCin / 128;   // 128 floats a step
constexpr int kQuadsPerWarp = kFillSteps / kWarps;        // 9
constexpr int kQuadsPerTap = kQuadsPerWarp / kTaps;       // 1
constexpr int kQuadsPerRow = kWin / 4;                    // 6
static_assert(kTile == kWarps, "a warp owns one row of the tile");
static_assert(kWin % 4 == 0, "window fill layout");
static_assert(kFillSteps == kWarps * kTaps * kQuadsPerTap,
              "window fill per tap");

constexpr size_t smem_bytes(int cout) {
    return sizeof(float) * (2 * (size_t)kWinFloats
                            + (size_t)kTaps * kCin * cout * 2);
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite v, but on the integer pipe:
// half a unit added to the magnitude's bits, the 13 low bits cleared.
__device__ __forceinline__ float tf32_hi(float v) {
    return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// d += a (16 x 8, row) * b (8 x 8, col) in TF32, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TileAt {
    int n, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(int tile, int tiles_x,
                                          int tiles_per_image) {
    const int n = tile / tiles_per_image;
    const int r = tile - n * tiles_per_image;
    const int ty = r / tiles_x;
    return {n, ty * kTile, (r - ty * tiles_x) * kTile};
}

// The window is filled in 144 steps of 4 pixel quads x 8 channels: the
// window's pixel quads in row-major order (6 a row), 4 consecutive ones
// a step, lane (i, c8) loading channel c = 16 (c8 >> 2) + 4q + (c8 & 3)
// of window quad 4 (step / 4) + i, where q = step % 4 (16 bytes of x
// when W is a multiple of 4, else 4 scalars; 8 channels x 64 contiguous
// bytes a warp) into registers and, a tap later, storing it to the
// quad's 4 pixel rows. Pixel w's channel quad q of each half sits at q ^
// ((w >> 2) & 3), its quad's index mod 4: the 4 quads of a step differ
// there, so the stores hit 32 banks. Warp v owns steps 9v..9v+8, one a
// tap. Outside the image the pixels are 0. `xn` is the tile's image.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ xn,
                                            TileAt at, int u, int warp,
                                            int H, int W, int lane,
                                            bool vec) {
    const int step = warp * kQuadsPerWarp + u;        // 0..143
    const int group = step >> 2, q = step & 3;
    const int wq = 4 * group + (lane & 3);            // window quad
    const int c = 16 * (lane >> 4) + 4 * q + ((lane >> 2) & 3);
    const int gy = at.y0 - kHalo + wq / kQuadsPerRow;
    const int gx = at.x0 - kHalo + 4 * (wq % kQuadsPerRow);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy < 0 || gy >= H) return v;
    const float* row = xn + (size_t)c * H * W + gy * W;
    if (vec) {   // gx and W multiples of 4: the quad is all in or all out
        if (gx >= 0 && gx < W)
            v = __ldg(reinterpret_cast<const float4*>(row + gx));
        return v;
    }
    v.x = (gx >= 0 && gx < W) ? __ldg(row + gx) : 0.f;
    v.y = (gx + 1 >= 0 && gx + 1 < W) ? __ldg(row + gx + 1) : 0.f;
    v.z = (gx + 2 >= 0 && gx + 2 < W) ? __ldg(row + gx + 2) : 0.f;
    v.w = (gx + 3 >= 0 && gx + 3 < W) ? __ldg(row + gx + 3) : 0.f;
    return v;
}

__device__ __forceinline__ void store_quad(float* win, float4 v, int u,
                                           int warp, int lane) {
    const int step = warp * kQuadsPerWarp + u;
    const int group = step >> 2, q = step & 3;
    const int wq = 4 * group + (lane & 3);
    // Pixels 4 wq + j: (w >> 2) & 3 == wq & 3 == lane & 3 (kWin % 4 == 0).
    float* p = win + 4 * wq * kCin + 16 * (lane >> 4) + ((lane >> 2) & 3)
               + 4 * (q ^ (lane & 3));
    p[0 * kCin] = v.x;
    p[1 * kCin] = v.y;
    p[2 * kCin] = v.z;
    p[3 * kCin] = v.w;
}

// A tile as a lane sees it: where it lies, its image, its image's
// offsets and mask, and the lane's 2 pixels: row `warp` of the tile,
// columns g and g + 8 (slots 0 and 1), as flat indices in the image (-1
// outside it).
struct Tile {
    TileAt at;
    const float* xn;
    const float* off;
    const float* msk;
    int pix[2];
};

__device__ __forceinline__ Tile tile_for(
        int tile, int tiles_x, int tiles_per_image,
        const float* __restrict__ x, const float* __restrict__ offset,
        const float* __restrict__ mask, int H, int W, int warp, int lane) {
    Tile tl;
    tl.at = tile_at(tile, tiles_x, tiles_per_image);
    const size_t HW = (size_t)H * W;
    tl.xn = x + (size_t)tl.at.n * kCin * HW;
    tl.off = offset + (size_t)tl.at.n * 2 * kTaps * HW;
    tl.msk = mask + (size_t)tl.at.n * kTaps * HW;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int py = tl.at.y0 + warp;
        const int px = tl.at.x0 + (lane >> 2) + 8 * s;
        tl.pix[s] = (py < H && px < W) ? py * W + px : -1;
    }
    return tl;
}

// Tap k's offsets and mask at this lane's 2 pixels of the tile (0
// outside the image).
__device__ __forceinline__ void fetch_tap(const Tile& tl, int k, int HW,
                                          float (&dy)[2], float (&dx)[2],
                                          float (&m)[2]) {
    const float* oy = tl.off + 2 * k * HW;
    const float* mk = tl.msk + k * HW;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int p = tl.pix[s];
        dy[s] = p >= 0 ? __ldg(oy + p) : 0.f;
        dx[s] = p >= 0 ? __ldg(oy + HW + p) : 0.f;
        m[s] = p >= 0 ? __ldg(mk + p) : 0.f;
    }
}

// A sample's four corners blended, the mask folded into the weights.
__device__ __forceinline__ float4 blend4(float4 a, float4 b, float4 c,
                                         float4 d, float w00, float w01,
                                         float w10, float w11) {
    auto one = [&](float c00, float c01, float c10, float c11) {
        return c00 * w00 + c01 * w01 + c10 * w10 + c11 * w11;
    };
    return make_float4(one(a.x, b.x, c.x, d.x), one(a.y, b.y, c.y, d.y),
                       one(a.z, b.z, c.z, d.z), one(a.w, b.w, c.w, d.w));
}

// A sample whose corners leave the window, from x in device memory, each
// corner checked against the image as the plain version does: channels c
// .. c + 3 of image n.
__device__ __forceinline__ float4 sample_global(
        const float* __restrict__ x, int n, int c, float sy, float sx,
        float m, int H, int W) {
    const float fy = floorf(sy), fx = floorf(sx);
    const float wy = sy - fy, wx = sx - fx;
    const bool y0 = fy >= 0.f && fy < (float)H;
    const bool y1 = fy + 1.f >= 0.f && fy + 1.f < (float)H;
    const bool x0 = fx >= 0.f && fx < (float)W;
    const bool x1 = fx + 1.f >= 0.f && fx + 1.f < (float)W;
    const int i00 = (y0 && x0) ? (int)fy * W + (int)fx : 0;
    const int i01 = (y0 && x1) ? (int)fy * W + (int)fx + 1 : 0;
    const int i10 = (y1 && x0) ? ((int)fy + 1) * W + (int)fx : 0;
    const int i11 = (y1 && x1) ? ((int)fy + 1) * W + (int)fx + 1 : 0;
    const float w00 = (y0 && x0) ? (1.f - wx) * (1.f - wy) * m : 0.f;
    const float w01 = (y0 && x1) ? wx * (1.f - wy) * m : 0.f;
    const float w10 = (y1 && x0) ? (1.f - wx) * wy * m : 0.f;
    const float w11 = (y1 && x1) ? wx * wy * m : 0.f;
    const size_t HW = (size_t)H * W;
    const float* p = x + ((size_t)n * kCin + c) * HW;
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j, p += HW)
        e[j] = __ldg(p + i00) * w00 + __ldg(p + i01) * w01
               + __ldg(p + i10) * w10 + __ldg(p + i11) * w11;
    return make_float4(e[0], e[1], e[2], e[3]);
}

// One tap's samples of this lane's 2 pixels, u = channels 16 pi + 4t..,
// v = the other half's: from the window, branch-free, then, for the rare
// samples whose corners leave the window, again from x.
struct TapSamples {
    float4 u[2], v[2];
};

__device__ __forceinline__ void sample_window(
        const float* win, int k, float py0, float px0, float oy, float ox,
        const float (&cy)[2], const float (&cx)[2], const float (&cm)[2],
        int t, int pi, TapSamples& sm, bool& outside) {
    const float ky = (float)(k / 3), kx = (float)(k % 3);
    outside = false;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#if (DEFORM_CONV_ABLATE & 2)
        sm.u[s] = make_float4(0.5f, 0.25f, 0.125f, 1.f);   // timing only
        sm.v[s] = sm.u[s];
#else
        const float sy = (py0 + ky) + cy[s];
        const float sx = (px0 + (float)(8 * s) + kx) + cx[s];
        const float fy = floorf(sy), fx = floorf(sx);
        const float wy = sy - fy, wx = sx - fx;
        const float ry = fy - oy, rx = fx - ox;
        const bool in = ry >= 0.f && ry <= (float)(kWin - 2) && rx >= 0.f
                        && rx <= (float)(kWin - 2);
        outside |= !in;
        const int w = in ? (int)ry * kWin + (int)rx : 0;
        const float a = (1.f - wy) * cm[s], b = wy * cm[s];
        const float w00 = (1.f - wx) * a, w01 = wx * a;
        const float w10 = (1.f - wx) * b, w11 = wx * b;
        // Pixel w's quad t of half pi sits at quad t ^ ((w >> 2) & 3) of
        // that half; a row down, kWin / 4 = 6 quads on, at t ^ that ^ 2.
        const float* r0 = win + w * kCin + 16 * pi;
        const int s0 = t ^ ((w >> 2) & 3), s1 = t ^ (((w + 1) >> 2) & 3);
        const float* p00 = r0 + 4 * s0;
        const float* p01 = r0 + kCin + 4 * s1;
        const float* p10 = r0 + kWin * kCin + 4 * (s0 ^ 2);
        const float* p11 = r0 + (kWin + 1) * kCin + 4 * (s1 ^ 2);
        const int other = 16 - 32 * pi;     // the row's other half
        auto ld = [](const float* p) {
            return *reinterpret_cast<const float4*>(p);
        };
        sm.u[s] = blend4(ld(p00), ld(p01), ld(p10), ld(p11), w00, w01, w10,
                         w11);
        sm.v[s] = blend4(ld(p00 + other), ld(p01 + other), ld(p10 + other),
                         ld(p11 + other), w00, w01, w10, w11);
#endif
    }
}

__device__ __forceinline__ void sample_outside(
        const float* __restrict__ x, int n, int k, float py0, float px0,
        float oy, float ox, const float (&cy)[2], const float (&cx)[2],
        const float (&cm)[2], int H, int W, int t, int pi, TapSamples& sm) {
    const float ky = (float)(k / 3), kx = (float)(k % 3);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const float sy = (py0 + ky) + cy[s];
        const float sx = (px0 + (float)(8 * s) + kx) + cx[s];
        const float ry = floorf(sy) - oy, rx = floorf(sx) - ox;
        if (ry >= 0.f && ry <= (float)(kWin - 2) && rx >= 0.f
            && rx <= (float)(kWin - 2))
            continue;
        sm.u[s] = sample_global(x, n, 16 * pi + 4 * t, sy, sx, cm[s], H, W);
        sm.v[s] = sample_global(x, n, 16 * (1 - pi) + 4 * t, sy, sx, cm[s],
                                H, W);
    }
}

// The A fragments of a tap, split: slot h is row g + 8 h of the warp's
// m16 tile, registers a[h] (channel 4t + j) and a[2 + h] (16 + 4t + j)
// of k8 step j.
struct Frags {
    uint32_t hi[kSteps][4], lo[kSteps][4];
};

__device__ __forceinline__ void split(const TapSamples& sm, int pi,
                                      Frags& a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float4 l4 = pi ? sm.v[h] : sm.u[h];
        const float4 h4 = pi ? sm.u[h] : sm.v[h];
        const float lo[4] = {l4.x, l4.y, l4.z, l4.w};
        const float hi[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
            const float l_hi = tf32_hi(lo[j]), h_hi = tf32_hi(hi[j]);
            a.hi[j][h] = __float_as_uint(l_hi);
            a.lo[j][h] = __float_as_uint(lo[j] - l_hi);
            a.hi[j][2 + h] = __float_as_uint(h_hi);
            a.lo[j][2 + h] = __float_as_uint(hi[j] - h_hi);
        }
    }
}

// Tap k's contraction: three TF32 products a multiply-add. Narrow
// outputs keep the lo products in accumulators of their own (NACC 2), so
// that more independent chains of products are in flight.
template <int NT, int NACC>
__device__ __forceinline__ void contract(const float4* wfrag, int k, int lane,
                                         const Frags& a,
                                         float (&acc)[NACC][NT][4]) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const float4 b = wfrag[((k * kSteps + j) * NT + nt) * 32 + lane];
            const uint32_t bh0 = __float_as_uint(b.x);
            const uint32_t bh1 = __float_as_uint(b.y);
            const uint32_t bl0 = __float_as_uint(b.z);
            const uint32_t bl1 = __float_as_uint(b.w);
#if (DEFORM_CONV_ABLATE & 4)
            // timing only: no products, the samples summed
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[0][nt][e] += __uint_as_float(a.hi[j][e])
                                 + __uint_as_float(a.lo[j][e]) * b.x;
            (void)bh0; (void)bh1; (void)bl0; (void)bl1;
#else
            mma_tf32(acc[NACC - 1][nt], a.lo[j], bh0, bh1);
            mma_tf32(acc[NACC - 1][nt], a.hi[j], bl0, bl1);
            mma_tf32(acc[0][nt], a.hi[j], bh0, bh1);
#endif
        }
    }
}

__device__ __forceinline__ float bias_at(const float* __restrict__ bias,
                                        int co) {
    return bias ? __ldg(bias + co) : 0.f;
}

template <int COUT>
__global__ void __launch_bounds__(kThreads, 1)
deform_conv_kernel(const float* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int tiles_x, int tiles_per_image,
                   int n_tiles) {
    constexpr int NT = COUT / 8;               // n8 tiles of the output
    constexpr int NACC = NT < 4 ? 2 : 1;
    extern __shared__ float4 smem4[];
    float* const wins = reinterpret_cast<float*>(smem4);   // two windows
    float4* const wfrag = smem4 + 2 * kWinFloats / 4;  // [9][4][NT][32]
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3, pi = g & 1;
    const int HW = H * W;
    // 16-byte window loads where every row of x starts 16-byte aligned.
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

    // The weights split once per block, in B-fragment order: lane (g, t)
    // of k8 step j, n8 tile nt holds rows 4t + j and 16 + 4t + j (the
    // channels its A fragments carry) of output channel 8 nt + g.
    for (int i = tid; i < kTaps * kSteps * NT * 32; i += kThreads) {
        const int ln = i & 31;
        int r = i >> 5;
        const int nt = r % NT;
        r /= NT;
        const int j = r % kSteps, k = r / kSteps;
        const int co = nt * 8 + (ln >> 2), ch = 4 * (ln & 3) + j;
        const float w0 = weight[(k * kCin + ch) * COUT + co];
        const float w1 = weight[(k * kCin + 16 + ch) * COUT + co];
        const float h0 = tf32_hi(w0), h1 = tf32_hi(w1);
        wfrag[i] = make_float4(h0, h1, w0 - h0, w1 - h1);
    }

    int tile = blockIdx.x;
    if (tile >= n_tiles) return;
    Tile tl = tile_for(tile, tiles_x, tiles_per_image, x, offset, mask, H,
                       W, warp, lane);
    for (int u = 0; u < kQuadsPerWarp; ++u)
        store_quad(wins, load_quad(tl.xn, tl.at, u, warp, H, W, lane, vec), u,
                   warp, lane);
    float dy[2], dx[2], m[2];       // the next tap's offsets and mask
#if !(DEFORM_CONV_ABLATE & 2)
    fetch_tap(tl, 0, HW, dy, dx, m);
#endif
    __syncthreads();

    for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
        const float* win = wins + (it & 1) * kWinFloats;
        float* next_win = wins + ((it + 1) & 1) * kWinFloats;
        const int next = tile + gridDim.x;
        const bool has_next = next < n_tiles;
        const Tile nx = tile_for(next, tiles_x, tiles_per_image, x, offset,
                                 mask, H, W, warp, lane);
        // The tile's window origin and this lane's pixels, as floats.
        const float oy = (float)(tl.at.y0 - kHalo);
        const float ox = (float)(tl.at.x0 - kHalo);
        const float py0 = (float)(tl.at.y0 + warp - 1);
        const float px0 = (float)(tl.at.x0 + g - 1);
        float acc[NACC][NT][4];
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[a][nt][e] = 0.f;
        float cy[2], cx[2], cm[2];      // the sampled tap's
        auto take = [&]() {
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                cy[s] = dy[s];
                cx[s] = dx[s];
                cm[s] = m[s];
            }
        };
        TapSamples sm;
        Frags a;
        bool outside;
        float4 quad[kQuadsPerTap];

#pragma unroll 1
        for (int k = 0; k < kTaps; ++k) {
#if !(DEFORM_CONV_ABLATE & 1)
            // The next window: store the quad loaded a tap ago, load one.
            if (has_next) {
                if (k > 0)
#pragma unroll
                    for (int q = 0; q < kQuadsPerTap; ++q)
                        store_quad(next_win, quad[q],
                                   (k - 1) * kQuadsPerTap + q, warp, lane);
#pragma unroll
                for (int q = 0; q < kQuadsPerTap; ++q)
                    quad[q] = load_quad(nx.xn, nx.at, k * kQuadsPerTap + q,
                                        warp, H, W, lane, vec);
            }
#endif
            take();
#if !(DEFORM_CONV_ABLATE & 2)
            if (k + 1 < kTaps)
                fetch_tap(tl, k + 1, HW, dy, dx, m);
            else if (has_next)
                fetch_tap(nx, 0, HW, dy, dx, m);
#endif
            sample_window(win, k, py0, px0, oy, ox, cy, cx, cm, t, pi, sm,
                          outside);
#if !(DEFORM_CONV_ABLATE & 2)
            if (outside)
                sample_outside(x, tl.at.n, k, py0, px0, oy, ox, cy, cx, cm,
                               H, W, t, pi, sm);
#endif
            split(sm, pi, a);
            contract<NT, NACC>(wfrag, k, lane, a, acc);
        }
#if !(DEFORM_CONV_ABLATE & 1)
        if (has_next)
#pragma unroll
            for (int q = 0; q < kQuadsPerTap; ++q)
                store_quad(next_win, quad[q], (kTaps - 1) * kQuadsPerTap + q,
                           warp, lane);
#endif

        // Bias and store: element e of n8 tile nt is pixel slot e >> 1,
        // output channel 8 nt + 2t + (e & 1).
        float* out_n = out + (size_t)tl.at.n * COUT * HW;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = tl.pix[e >> 1];
            if (p < 0) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                float v = acc[0][nt][e];
                if (NACC > 1) v += acc[NACC - 1][nt][e];
                out_n[(size_t)(nt * 8 + 2 * t + (e & 1)) * HW + p] =
                    v + ((e & 1) ? bias_at(bias, nt * 8 + 2 * t + 1)
                                 : bias_at(bias, nt * 8 + 2 * t));
            }
        }

        // The next window in place and every warp done with this one.
        __syncthreads();
        tl = nx;
    }
}

// Per device and Cout, the kernel's shared-memory attribute is set and
// its resident blocks counted once, not on every launch.
constexpr int kMaxDevices = 64;

template <int COUT>
cudaError_t launch(const float* x, const float* offset, const float* mask,
                   const float* weight, const float* bias, float* out, int N,
                   int H, int W, cudaStream_t stream) {
    static int grid_cap[kMaxDevices];
    auto kernel = deform_conv_kernel<COUT>;
    constexpr size_t smem = smem_bytes(COUT);
    cudaError_t err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (grid_cap[dev] == 0) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kernel, kThreads, smem)) != cudaSuccess)
            return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        grid_cap[dev] = sms * per_sm;
    }
    const int tiles_x = (W + kTile - 1) / kTile;
    const int tiles_per_image = tiles_x * ((H + kTile - 1) / kTile);
    const int n_tiles = N * tiles_per_image;
    const int grid = n_tiles < grid_cap[dev] ? n_tiles : grid_cap[dev];
    kernel<<<grid, kThreads, smem, stream>>>(x, offset, mask, weight, bias,
                                             out, H, W, tiles_x,
                                             tiles_per_image, n_tiles);
    return cudaGetLastError();
}

}  // namespace

// The wrapper's geometry (tile, halo, shared-memory bytes) must be the
// kernel's: it is refused otherwise.
extern "C" int deform_conv2d_launch(const float* x, const float* offset,
                                    const float* mask, const float* weight,
                                    const float* bias, float* out, int n,
                                    int cin, int cout, int H, int W,
                                    int tile, int halo, long long smem,
                                    void* stream) {
    if (cin != kCin || n < 1 || H < 1 || W < 1 || tile != kTile
        || halo != kHalo || smem != (long long)smem_bytes(cout))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (cout) {
        case 8:
            return (int)launch<8>(x, offset, mask, weight, bias, out, n, H,
                                  W, s);
        case 16:
            return (int)launch<16>(x, offset, mask, weight, bias, out, n, H,
                                   W, s);
        case 32:
            return (int)launch<32>(x, offset, mask, weight, bias, out, n, H,
                                   W, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* deform_conv2d_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
