// cost_mapping for Hopper (sm_90a): every VolSDF ray sample projected
// into every training view and the view's MVS probability volume read
// trilinearly there, reduced over the views to the GCE loss's inputs.
//
// Replaces the XLA op s_volsdf_tpu/ops/cost_mapping.py:152-242
// (_sample_all_views) and the reduction in cost_mapping (:325-352). It
// computes, per sample and for each of the V views, in float32, what
// the port's plain version (s_volsdf_tpu_torch/ops/cost_mapping.py,
// _sample_all_views + cost_mapping) computes, in its order of
// operations:
//   * the camera-frame point p = R^T (x - t) (sums in the order
//     p0 R0j + p1 R1j + p2 R2j), the pixel with the skew term and its
//     [-1, 1] coordinates; the bound_hw test (|u|, |v| <= 1.001, z >=
//     1e-5), which puts an invalid sample at -99;
//   * the bilinear near/far slab lookup (align_corners=True), corner
//     weights from the unclamped floor, a corner past the edge read as
//     0, the linear or inverse-depth normalisation of the depth into
//     the slab and the bound_z test (|zg| <= 1.01, near and far >= 1e-5);
//   * the trilinear lookup of the (D, Hv, Wv) volume in the same way,
//     each value promoted to f32 before its weight (a bf16 volume is the
//     pack the JAX package's mvs_pack_dtype="bfloat16" makes);
//   * pi = sum_v onehot_v cost_v, pj = sum_v (1 - onehot_v) cost_v,
//     valid = any_v (onehot_v == 0 and sample valid in v), pi = 0 where
//     not valid.
// Built with --fmad=false: every product and sum rounds on its own, as
// the plain version's eager torch ops do, so that the masks, which
// decide where pi jumps, equal the plain version's on the card.
//
// The bound. A sample costs per view 4 corners x 2 planes of the slab
// and 8 corners of the volume; corners x and x + 1 share a 32-byte
// sector (most of the time), rows y and y + 1 and planes z and z + 1 do
// not: 8 sectors, 256 bytes, read per sample and view, and 12 + 9 bytes
// of the sample's own input and output. At bench.py's shapes (512 rays
// x 96 samples, 3 views) that is at most 38.8 MB, 11.6 us at 3.35 TB/s;
// samples along one ray share sectors, and chip_smoke.py counts the
// distinct sectors this run's samples touch (ops/cost_mapping.py:
// touched_bytes) for its bound. The arithmetic is about 300 float
// operations per sample and view with 6 divisions, 44 M per step at
// those shapes: microseconds at the FP32 rate. So sectors bound it, not
// operations, and a bf16 volume halves its footprint (the cascade's
// three 192 x 288 x 384 volumes: 127 MB instead of 255 MB) but not its
// sectors: an element's sector is fetched whole either way.
//
// One thread per sample, 256 to a block, looping over the views; the
// cameras are read through the read-only cache. Plain C entry points,
// bound with ctypes (ops/cost_mapping.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The linear weight of corner offset i from the true floor corner: 1 - w
// at 0, w at 1, 0 for any other offset (a corner clamped away).
__device__ __forceinline__ float corner_wgt(int i, float w) {
  return i == 0 ? 1.0f - w : (i == 1 ? w : 0.0f);
}

// align_corners=True: [-1, 1] to index space, ((c + 1) * 0.5) * (size - 1).
__device__ __forceinline__ float unnormalize(float c, int size) {
  return ((c + 1.0f) * 0.5f) * (float)(size - 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cost_mapping_kernel(const float* __restrict__ xyz, int n,
                    const T* __restrict__ prob,
                    const float* __restrict__ slab,
                    const float* __restrict__ intr,
                    const float* __restrict__ c2w,
                    const float* __restrict__ onehot, int V, int D, int Hv,
                    int Wv, float u_scale, float v_scale, int inverse_depth,
                    float* __restrict__ pj_out, float* __restrict__ pi_out,
                    bool* __restrict__ valid_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  const long long plane = (long long)Hv * Wv;
  float pi = 0.0f, pj = 0.0f;
  bool valid = false;
  for (int v = 0; v < V; ++v) {
    const float* E = c2w + 16 * v;
    const float* K = intr + 16 * v;
    const float p0 = x - __ldg(E + 3), p1 = y - __ldg(E + 7),
                p2 = z - __ldg(E + 11);
    const float pc0 = p0 * __ldg(E + 0) + p1 * __ldg(E + 4) + p2 * __ldg(E + 8);
    const float pc1 = p0 * __ldg(E + 1) + p1 * __ldg(E + 5) + p2 * __ldg(E + 9);
    const float zc = p0 * __ldg(E + 2) + p1 * __ldg(E + 6) + p2 * __ldg(E + 10);
    const float fx = __ldg(K + 0), sk = __ldg(K + 1), cx = __ldg(K + 2);
    const float fy = __ldg(K + 5), cy = __ldg(K + 6);
    const float xz = pc0 / zc, yz = pc1 / zc;
    const float v_pix = yz * fy + cy;
    const float u_pix = (xz * fx + cx) + ((v_pix - cy) * sk) / fy;
    float u = u_pix * u_scale - 1.0f;
    float vv = v_pix * v_scale - 1.0f;
    const bool invalid = (zc < 1e-5f) || (u > 1.001f) || (u < -1.001f) ||
                         (vv > 1.001f) || (vv < -1.001f);
    if (invalid) u = vv = -99.0f;

    const float fxi = unnormalize(u, Wv), fyi = unnormalize(vv, Hv);
    const int x0 = (int)floorf(fxi), y0 = (int)floorf(fyi);
    const int xs = min(max(x0, 0), Wv - 1), ys = min(max(y0, 0), Hv - 1);
    const int sx = x0 - xs, sy = y0 - ys;
    const float wx = fxi - (float)x0, wy = fyi - (float)y0;

    // Bilinear near/far planes; a corner past the edge reads 0.
    const float* sl = slab + 2 * plane * v;
    float near = 0.0f, far = 0.0f;
    for (int by = 0; by < 2; ++by) {
      for (int bx = 0; bx < 2; ++bx) {
        const int yb = ys + by, xb = xs + bx;
        const bool inb = (yb < Hv) && (xb < Wv);
        const long long pix = (long long)min(yb, Hv - 1) * Wv + min(xb, Wv - 1);
        const float w = corner_wgt(by - sy, wy) * corner_wgt(bx - sx, wx);
        const float nv = inb ? __ldg(sl + pix) : 0.0f;
        const float fv = inb ? __ldg(sl + plane + pix) : 0.0f;
        near = near + nv * w;
        far = far + fv * w;
      }
    }

    float zg;
    if (inverse_depth) {
      const float far_safe = far < 1e-5f ? 1e-8f : far;
      zg = (2.0f * (1.0f - near / zc)) / (1.0f - near / far_safe) - 1.0f;
    } else {
      zg = (2.0f * (zc - near)) / (far - near) - 1.0f;
    }
    const bool invalid_f = (near < 1e-5f) || (far < 1e-5f) || (zg > 1.01f) ||
                           (zg < -1.01f) || invalid;
    const float zn = unnormalize(invalid_f ? -99.0f : zg, D);
    const float z0f = floorf(zn);
    const int z0 = (int)z0f;
    const int zs = min(max(z0, 0), D - 1);
    const int sz = z0 - zs;
    const float wz = zn - z0f;

    // Trilinear volume lookup; a corner past the edge reads 0.
    const T* vol = prob + (long long)D * plane * v;
    float cost = 0.0f;
    for (int by = 0; by < 2; ++by) {
      for (int bx = 0; bx < 2; ++bx) {
        const int yb = ys + by, xb = xs + bx;
        const bool inb_xy = (yb < Hv) && (xb < Wv);
        const float wxy = corner_wgt(by - sy, wy) * corner_wgt(bx - sx, wx);
        const long long pix = (long long)min(yb, Hv - 1) * Wv + min(xb, Wv - 1);
        for (int bz = 0; bz < 2; ++bz) {
          const int zb = zs + bz;
          const bool inb = inb_xy && (zb < D);
          const float val =
              inb ? to_f32(vol[(long long)min(zb, D - 1) * plane + pix]) : 0.0f;
          cost = cost + val * (wxy * corner_wgt(bz - sz, wz));
        }
      }
    }

    const float w_same = __ldg(onehot + v);
    pi = pi + w_same * cost;
    pj = pj + (1.0f - w_same) * cost;
    valid = valid || ((w_same == 0.0f) && !invalid_f);
  }
  pj_out[i] = pj;
  pi_out[i] = valid ? pi : 0.0f;
  valid_out[i] = valid;
}

extern "C" {

// Launches on `stream`; prob is float32 (prob_bf16 = 0) or bf16.
// Returns cudaGetLastError() (0 on success).
int cost_mapping_launch(const float* xyz, int n, const void* prob,
                        int prob_bf16, const float* slab, const float* intr,
                        const float* c2w, const float* onehot, int V, int D,
                        int Hv, int Wv, float u_scale, float v_scale,
                        int inverse_depth, float* pj, float* pi, bool* valid,
                        cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    if (prob_bf16)
      cost_mapping_kernel<__nv_bfloat16><<<blocks, THREADS, 0, stream>>>(
          xyz, n, static_cast<const __nv_bfloat16*>(prob), slab, intr, c2w,
          onehot, V, D, Hv, Wv, u_scale, v_scale, inverse_depth, pj, pi,
          valid);
    else
      cost_mapping_kernel<float><<<blocks, THREADS, 0, stream>>>(
          xyz, n, static_cast<const float*>(prob), slab, intr, c2w, onehot,
          V, D, Hv, Wv, u_scale, v_scale, inverse_depth, pj, pi, valid);
  }
  return (int)cudaGetLastError();
}

const char* cost_mapping_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
