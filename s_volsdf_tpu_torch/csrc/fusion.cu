// Geometric-consistency check of one (reference, source) pair of depth
// maps, one thread per reference pixel: the core of depth fusion.
//
// Replaces the host C++ core s_volsdf_tpu/native/fusion.cpp:59-105
// (`geo_consistency`, OpenMP over rows; not a Pallas kernel) and
// computes what it computes, per pixel, in float64:
//   1. lift the reference pixel (x, y, d): invK_ref * (x d, y d, d);
//   2. move it into the source camera (R_rs, t_rs), project with K_src,
//      the depth clamped to >= 1e-12;
//   3. sample the source depth bilinearly at (xs, ys); a corner outside
//      the image contributes 0 (cv2.remap, BORDER_CONSTANT);
//   4. lift that sample in the source camera, return to the reference
//      camera (R_sr, t_sr) and project with K_ref;
//   5. the pixel passes if the round trip moved it less than
//      filter_dist pixels and the relative depth difference is below
//      filter_diff; depth_out is the reprojected depth there, else 0.
//
// The depth maps are the float32 PFMs; each value is promoted to double
// in registers (exact, as the JAX package's cast is). Built with
// --fmad=false: every product and sum rounds on its own, in the host
// C++'s order, so the masks equal the plain version's and the host's
// exactly, not merely closely.
//
// Bound: FP64 operations, not bytes. A pixel reads 4 + 4 bytes (its
// reference depth, and the source depth around its projection, each map
// read once) and writes 1 (mask) + 8 (depth) bytes, + 16 when the
// caller asks for the source coordinates: 9.0 us for a 1152 x 1536 pair
// at 3.35 TB/s. Its float64 arithmetic is more: `cuobjdump -sass` of
// the sm_90a build counts 246 FP64-pipe instructions in the kernel's
// straight line, one thread's (DADD 58, DFMA 57, DMUL 84, DSETP 19, the
// F64 conversions 18, FRND 2, MUFU.RCP64H 6, MUFU.RSQ64H 2;
// tools/fp64_count.py), and the H100 issues 64 of them a clock per SM
// (34 TFLOP/s FP64 outside the tensor cores): 246 x 1,769,472 / (132 x
// 64 x 1.98 GHz) = 26.0 us. Measured 34-35 us (PERF.md), three quarters
// of that bound, so the kernel is left as it is. The design keeps it one
// pass: the camera matrices ride in the kernel's parameters (broadcast
// from the constant bank), neighbouring threads read neighbouring
// reference pixels, and the four source reads of a pixel are neighbours
// of its neighbours'.

#include <cstdint>
#include <cuda_runtime.h>

struct GeoMats {
    double invK_ref[9];
    double K_src[9];
    double invK_src[9];
    double K_ref[9];
    double R_rs[9];      // reference camera -> source camera
    double t_rs[3];
    double R_sr[9];      // source camera -> reference camera
    double t_sr[3];
};

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void mat3v(const double* M, double a, double b,
                                      double c, double* out) {
    out[0] = M[0] * a + M[1] * b + M[2] * c;
    out[1] = M[3] * a + M[4] * b + M[5] * c;
    out[2] = M[6] * a + M[7] * b + M[8] * c;
}

__device__ __forceinline__ double bilinear(const float* __restrict__ img,
                                           int H, int W, double x,
                                           double y) {
    const double fx = floor(x), fy = floor(y);
    const double wx = x - fx, wy = y - fy;
    const double w[4] = {(1.0 - wx) * (1.0 - wy), wx * (1.0 - wy),
                         (1.0 - wx) * wy, wx * wy};
    const double cx[4] = {fx, fx + 1.0, fx, fx + 1.0};
    const double cy[4] = {fy, fy, fy + 1.0, fy + 1.0};
    double v = 0.0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        // Compared as doubles: NaN and far-out coordinates fail here,
        // before any conversion to an index.
        if (cx[c] >= 0.0 && cx[c] < W && cy[c] >= 0.0 && cy[c] < H) {
            const int64_t i = (int64_t)cy[c] * W + (int64_t)cx[c];
            v += (double)img[i] * w[c];
        }
    }
    return v;
}

__global__ void __launch_bounds__(kThreads)
geo_consistency_kernel(const float* __restrict__ depth_ref,
                       const float* __restrict__ depth_src, int H, int W,
                       const GeoMats m, double filter_dist,
                       double filter_diff, uint8_t* __restrict__ mask_out,
                       double* __restrict__ depth_out,
                       double* __restrict__ xs_out,
                       double* __restrict__ ys_out) {
    // One block row of kThreads pixels per grid cell: (x blocks, rows).
    const int xi = blockIdx.x * kThreads + threadIdx.x, yi = blockIdx.y;
    if (xi >= W) return;
    const int64_t idx = (int64_t)yi * W + xi;
    const double d = (double)depth_ref[idx];
    const double x = (double)xi, y = (double)yi;

    double pr[3], ps[3], k[3];
    mat3v(m.invK_ref, x * d, y * d, d, pr);
    mat3v(m.R_rs, pr[0], pr[1], pr[2], ps);
    ps[0] += m.t_rs[0];
    ps[1] += m.t_rs[1];
    ps[2] += m.t_rs[2];
    mat3v(m.K_src, ps[0], ps[1], ps[2], k);
    const double z = k[2] > 1e-12 ? k[2] : 1e-12;
    const double xs = k[0] / z, ys = k[1] / z;
    if (xs_out != nullptr) {
        xs_out[idx] = xs;
        ys_out[idx] = ys;
    }
    const double sampled = bilinear(depth_src, H, W, xs, ys);

    double ps2[3], pr2[3];
    mat3v(m.invK_src, xs * sampled, ys * sampled, sampled, ps2);
    mat3v(m.R_sr, ps2[0], ps2[1], ps2[2], pr2);
    pr2[0] += m.t_sr[0];
    pr2[1] += m.t_sr[1];
    pr2[2] += m.t_sr[2];
    const double depth_reproj = pr2[2];
    mat3v(m.K_ref, pr2[0], pr2[1], pr2[2], k);
    const double z2 = k[2] > 1e-12 ? k[2] : 1e-12;
    const double x2 = k[0] / z2, y2 = k[1] / z2;

    const double dist = sqrt((x2 - x) * (x2 - x) + (y2 - y) * (y2 - y));
    const double dref = d > 1e-12 ? d : 1e-12;
    const double rel = fabs(depth_reproj - d) / dref;
    const bool ok = dist < filter_dist && rel < filter_diff;
    mask_out[idx] = ok ? 1 : 0;
    depth_out[idx] = ok ? depth_reproj : 0.0;
}

}  // namespace

// One launch on `stream`; xs_out/ys_out may both be null (the source
// coordinates are not written then). H <= 65,535 (the grid's rows).
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int geo_consistency_launch(
    const float* depth_ref, const float* depth_src, int H, int W,
    GeoMats mats, double filter_dist, double filter_diff, uint8_t* mask_out,
    double* depth_out, double* xs_out, double* ys_out, void* stream) {
    if ((int64_t)H * W == 0) return 0;
    const dim3 grid((W + kThreads - 1) / kThreads, H);
    geo_consistency_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        depth_ref, depth_src, H, W, mats, filter_dist, filter_diff, mask_out,
        depth_out, xs_out, ys_out);
    return (int)cudaGetLastError();
}

extern "C" const char* geo_consistency_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
