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
// Layouts are channel-major, one image: x (32, H, W), offset (18, H, W),
// mask (9, H, W), out (Cout, H, W), Cout 8, 16 or 32; and a scratch
// x_hwc (H, W, 32) from the caller.
//
// Bound: operations on the FP32 pipe. At TransMVSNet's largest launch
// (1152 x 1536 pixels, 32 -> 32) a pixel does 9 x 32 x (4 + 32) fused
// multiply-adds (the four corners of each sample, then the contraction):
// 18.3 G, 0.55 ms at 132 SMs x 128 lanes x 2 flops x 1.98 GHz. Its bytes,
// x, the 27 offset and mask channels and the output each once, are 0.64
// GB: 0.19 ms at 3.35 TB/s.
//
// Design (simple first). A first kernel writes x channel-last (x_hwc),
// through shared memory so that both sides are coalesced, so that a
// bilinear corner's 32 channels are one 128-byte row: the gather is one
// request a corner, not 32 (the lever of the JAX package's packed-corner
// gather). The main kernel's block owns a tile of 256 consecutive output
// pixels and walks over tiles (one resident wave of blocks); the whole
// weight, 9 x 32 x Cout floats (36 KB at most), is staged in shared
// memory once per block. For each tap its warps first sample the tile's
// pixels once, 8 lanes a pixel and 4 channels a lane (corner weights and
// mask applied), into shared memory: the bilinear work is not repeated
// per output channel. Then each thread accumulates Cout / 8 pixels x 8
// output channels: per 4 input channels, one 16-byte load of each of its
// pixels' samples and eight broadcast loads of the weights feed 32 x Cout
// / 8 fused multiply-adds. Rows of 36 floats keep both shared-memory
// patterns free of bank conflicts. Sampling and contraction are split by
// barriers and overlap only across the 3 resident blocks of an SM.
//
// Its time against the bound, and the split between sampling and
// contraction (tools/time_deform_conv.py --ablate), are in PERF.md. The
// sampling moves 36 corner rows of 128 bytes a pixel (8.2 GB at the
// largest launch) through L2: a tile's footprint in shared memory, and
// the contraction on the tensor cores, are the redesign's levers.

#include <cstdint>
#include <cuda_runtime.h>

// Timing builds only (tools/time_deform_conv.py --ablate): 1 skips the
// sampling (the samples are zero), 2 contracts 4 of the 32 channels.
#ifndef DEFORM_CONV_ABLATE
#define DEFORM_CONV_ABLATE 0
#endif

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kTile = 256;      // output pixels a block works on at once
constexpr int kCin = 32;
constexpr int kRow = kCin + 4;  // a sampled pixel's row in shared memory

template <int COUT>
__global__ void __launch_bounds__(kThreads)
deform_conv_kernel(const float* __restrict__ x_hwc,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int n_tiles) {
    constexpr int G = COUT / 8;          // groups of 8 output channels
    constexpr int PT = G;                // pixels a thread contracts
    constexpr int PG = kTile / PT;       // threads a group (>= 64)
    extern __shared__ float4 smem4[];
    float* w_s = reinterpret_cast<float*>(smem4);      // [9 * 32][COUT]
    float* s_s = w_s + kTaps * kCin * COUT;            // [kTile][kRow]
    const int HW = H * W;
    const int tid = threadIdx.x;
    for (int i = tid; i < kTaps * kCin * COUT; i += kThreads)
        w_s[i] = weight[i];

    const int g = tid / PG;
    const int pg = tid % PG;
    const int warp = tid / 32, lane = tid % 32;
    const int q = lane / 8, cq = lane % 8;   // pixel of 4, channel quad of 8
    const float4* xq = reinterpret_cast<const float4*>(x_hwc) + cq;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int p0 = tile * kTile;
        // This lane's 8 sampling pixels (one a step), the same every tap.
        int sp_y[8], sp_x[8];
#pragma unroll
        for (int it = 0; it < 8; ++it) {
            const int p = p0 + warp * 32 + it * 4 + q;
            sp_y[it] = p / W;
            sp_x[it] = p - sp_y[it] * W;
        }
        float acc[PT][8];
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

        for (int k = 0; k < kTaps; ++k) {
            // 1. Each warp samples 32 pixels, 4 at a time: 8 lanes a
            // pixel, 4 channels a lane, each corner one 128-byte row.
#pragma unroll
            for (int it = 0; it < 8; ++it) {
                const int lp = warp * 32 + it * 4 + q;
                const int p = p0 + lp;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#if DEFORM_CONV_ABLATE == 1
                if (false) {     // timing only: no sampling
#else
                if (p < HW) {
#endif
                    const int py = sp_y[it], px = sp_x[it];
                    const float dy = offset[(size_t)(2 * k) * HW + p];
                    const float dx = offset[(size_t)(2 * k + 1) * HW + p];
                    const float m = mask[(size_t)k * HW + p];
                    const float sy = (float)(py + k / 3 - 1) + dy;
                    const float sx = (float)(px + k % 3 - 1) + dx;
                    const float fy = floorf(sy), fx = floorf(sx);
                    const float wy = sy - fy, wx = sx - fx;
                    const bool y0 = fy >= 0.f && fy < (float)H;
                    const bool y1 = fy + 1.f >= 0.f && fy + 1.f < (float)H;
                    const bool x0 = fx >= 0.f && fx < (float)W;
                    const bool x1 = fx + 1.f >= 0.f && fx + 1.f < (float)W;
                    const int r0 = y0 ? (int)fy * W : 0;
                    const int r1 = y1 ? ((int)fy + 1) * W : 0;
                    const int c0 = x0 ? (int)fx : 0;
                    const int c1 = x1 ? (int)fx + 1 : 0;
                    const float w00 =
                        (y0 && x0) ? (1.f - wx) * (1.f - wy) : 0.f;
                    const float w01 = (y0 && x1) ? wx * (1.f - wy) : 0.f;
                    const float w10 = (y1 && x0) ? (1.f - wx) * wy : 0.f;
                    const float w11 = (y1 && x1) ? wx * wy : 0.f;
                    const float4 a = xq[(size_t)(r0 + c0) * (kCin / 4)];
                    const float4 b = xq[(size_t)(r0 + c1) * (kCin / 4)];
                    const float4 c = xq[(size_t)(r1 + c0) * (kCin / 4)];
                    const float4 d = xq[(size_t)(r1 + c1) * (kCin / 4)];
                    // The corners summed in the plain version's order.
                    auto blend = [&](float c00, float c01, float c10,
                                     float c11) {
                        return (c00 * w00 + c01 * w01 + c10 * w10
                                + c11 * w11) * m;
                    };
                    v.x = blend(a.x, b.x, c.x, d.x);
                    v.y = blend(a.y, b.y, c.y, d.y);
                    v.z = blend(a.z, b.z, c.z, d.z);
                    v.w = blend(a.w, b.w, c.w, d.w);
                }
                *reinterpret_cast<float4*>(s_s + lp * kRow + cq * 4) = v;
            }
            __syncthreads();

            // 2. Contract the tile's samples with tap k's weight rows.
            const float* wk = w_s + k * kCin * COUT + g * 8;
#pragma unroll 2
#if DEFORM_CONV_ABLATE == 2
            for (int c4 = 0; c4 < 1; ++c4) {   // timing only: 4 channels
#else
            for (int c4 = 0; c4 < kCin / 4; ++c4) {
#endif
                float4 s[PT];
#pragma unroll
                for (int i = 0; i < PT; ++i)
                    s[i] = *reinterpret_cast<const float4*>(
                        s_s + (i * PG + pg) * kRow + c4 * 4);
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    const float* wr = wk + (c4 * 4 + cc) * COUT;
                    const float4 wa = *reinterpret_cast<const float4*>(wr);
                    const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
                    const float w[8] = {wa.x, wa.y, wa.z, wa.w,
                                        wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                    for (int i = 0; i < PT; ++i) {
                        const float sv = cc == 0 ? s[i].x : cc == 1 ? s[i].y
                                       : cc == 2 ? s[i].z : s[i].w;
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            acc[i][j] = fmaf(sv, w[j], acc[i][j]);
                    }
                }
            }
            __syncthreads();
        }

        // 3. Bias and store: consecutive threads, consecutive pixels.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int co = g * 8 + j;
            const float b = bias ? bias[co] : 0.f;
#pragma unroll
            for (int i = 0; i < PT; ++i) {
                const int p = p0 + i * PG + pg;
                if (p < HW) out[(size_t)co * HW + p] = acc[i][j] + b;
            }
        }
    }
}

// x (32, HW) -> x_hwc (HW, 32), 64 pixels a block through shared memory:
// both the reads and the writes coalesced.
__global__ void __launch_bounds__(kThreads)
to_hwc_kernel(const float* __restrict__ x, float* __restrict__ x_hwc,
              int HW) {
    __shared__ float t[kCin][64 + 1];
    const int p0 = blockIdx.x * 64;
    for (int i = threadIdx.x; i < kCin * 64; i += kThreads) {
        const int c = i / 64, pp = i % 64;
        t[c][pp] = p0 + pp < HW ? x[(size_t)c * HW + p0 + pp] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kCin * 64; i += kThreads) {
        const int pp = i / kCin, c = i % kCin;
        if (p0 + pp < HW) x_hwc[(size_t)(p0 + pp) * kCin + c] = t[c][pp];
    }
}

template <int COUT>
cudaError_t launch(const float* x, float* x_hwc, const float* offset,
                   const float* mask, const float* weight, const float* bias,
                   float* out, int H, int W, cudaStream_t stream) {
    const int HW = H * W;
    const int n_tiles = (HW + kTile - 1) / kTile;
    const size_t smem = sizeof(float) * ((size_t)kTaps * kCin * COUT
                                         + (size_t)kTile * kRow);
    auto kernel = deform_conv_kernel<COUT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    to_hwc_kernel<<<(HW + 63) / 64, kThreads, 0, stream>>>(x, x_hwc, HW);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
    kernel<<<grid, kThreads, smem, stream>>>(x_hwc, offset, mask, weight,
                                             bias, out, H, W, n_tiles);
    return cudaGetLastError();
}

}  // namespace

// x_hwc: scratch of H * W * 32 floats, written by the launch.
extern "C" int deform_conv2d_launch(const float* x, float* x_hwc,
                                    const float* offset, const float* mask,
                                    const float* weight, const float* bias,
                                    float* out, int cin, int cout, int H,
                                    int W, void* stream) {
    if (cin != kCin || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (cout) {
        case 8:
            return (int)launch<8>(x, x_hwc, offset, mask, weight, bias, out,
                                  H, W, s);
        case 16:
            return (int)launch<16>(x, x_hwc, offset, mask, weight, bias, out,
                                   H, W, s);
        case 32:
            return (int)launch<32>(x, x_hwc, offset, mask, weight, bias, out,
                                   H, W, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* deform_conv2d_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
