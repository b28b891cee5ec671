// cost_mapping for Hopper (sm_90a): every VolSDF ray sample projected
// into every training view and the view's MVS probability volume read
// trilinearly there, reduced over the views to the GCE loss's inputs.
//
// Replaces the XLA op s_volsdf_tpu/ops/cost_mapping.py:152-242
// (_sample_all_views) and the reduction in cost_mapping (:325-352). It
// computes, per sample and for each of the V views, in float32, what
// the port's plain version (s_volsdf_tpu_torch/ops/cost_mapping.py,
// _sample_all_views + cost_mapping_plain) computes, in its order of
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
//     each summed from view 0 up as pi + w cost, valid = any_v
//     (onehot_v == 0 and sample valid in v), pi = 0 where not valid.
// Built with --fmad=false: every product and sum rounds on its own, as
// the plain version's eager torch ops do, so that the masks, which
// decide where pi jumps, and pi and pj themselves equal the plain
// version's on the card, bit for bit.
//
// The bound. A sample costs per view 4 corners x 2 planes of the slab
// and 8 corners of the volume; corners x and x + 1 share a 32-byte
// sector (most of the time), rows y and y + 1 and planes z and z + 1 do
// not. Samples along one ray share sectors, so chip_smoke.py counts the
// distinct sectors this run's samples touch in the layout the kernel
// reads, the corner-block copies below (ops/cost_mapping.py:
// packed_bytes), plus each sample's 12 + 9 bytes of input and output:
// 5.25 MB at bench.py's shapes (512 rays x 96 samples, three bf16
// 192 x 288 x 384 volumes), 1.6 us at 3.35 TB/s. In the volumes as the
// caller holds them (touched_bytes) the same samples touch 11.2 MB,
// 3.4 us. The arithmetic, about 300 float operations per sample
// and view with 6 divisions, is microseconds' worth at the FP32 rate. A
// training step finds the sectors cold, behind tens of MB of MLP
// activations in the 50 MB L2.
//
// What held the one-thread-per-sample kernel back (timed on an H100,
// PERF.md) was not HBM latency but the number of requests: every
// corner was its own 4-byte load, 16 a sample and view, 2.36 M sector
// requests a step, which the L2 serves at about 6 TB/s of 32-byte
// requests: 12-13 us warm, 22 us cold. So:
//   * The kernel reads packed copies that check_volumes makes once per
//     trainer run (ops/cost_mapping.py: corner_cubes, slab_cubes, 8x
//     the volume's bytes, the layout of the JAX package's pack_volumes):
//     a sample's 8 volume corners are one 16-byte (bf16) or 32-byte
//     (float32) block, its 2 x 2 near/far corners one 32-byte block.
//     That is 3 requests a sample and view (bf16; 4 in float32), not
//     16, each load unconditional, a corner past the edge selected to 0
//     after it.
//   * One thread per (sample, view), a sample's V views in V adjacent
//     lanes (`group`; 32 / V samples per warp): a step of 49,152 samples
//     is about 4,900 warps, all resident at once, each lane a chain of
//     three dependent round trips (its point and the cameras, the slab
//     block, the volume block). The group's leader then sums the views'
//     terms in view order through warp shuffles, exactly as the plain
//     version sums them; more than 32 views loop over rounds of 32 in
//     the same order.
//   * The cameras and the one-hot weights are read once per block into
//     shared memory; the launch's constant arguments (the packs'
//     pointers and the shapes) come in one struct that check_volumes
//     builds with the packs.
// 40 registers, no spills. Measured on an H100 (PERF.md): 13.7 us cold,
// 8.8 us warm, of which 5.0 us is the timing's own floor (an empty
// kernel timed the same way); what is left grows with the samples in
// L2 as in device memory, so instruction issue (the index, clamp and
// division arithmetic) bounds it, not bytes. Tried and dropped: a
// software pipeline over rounds of samples a warp (more registers,
// slower), blocks of 128 or 512 threads and cameras read from global
// memory (no change).
//
// The scene axis (cost_mapping_launch_scenes): S scenes' corner-block
// packs, cameras, one-hots, samples and outputs laid out one scene after
// another, all of one shape; one launch with blockIdx.y the scene. Each
// block moves its pointers to its scene's (and loads its scene's
// cameras into shared memory) and does what a single launch's block
// does, so the batched launch equals S single launches bit for bit (the
// lockstep multi-scene step, s_volsdf_tpu_torch/engine/multiscene.py).
//
// -DCOST_MAPPING_TRACE: each block's thread 0 records %globaltimer at its
// start and end and clock64() after its point and cameras and after its
// slab (tools/time_cost_mapping.py --trace reads them back), to show
// where a launch's time goes.
//
// Plain C entry points, bound with ctypes (ops/cost_mapping.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define CAM 18   // floats per view in shared memory: R (9), t (3),
                 // fx, sk, cx, fy, cy, onehot

// The launch's constant arguments: mirror of CostArgs in
// ops/cost_mapping.py, built once per set of volumes.
struct CostArgs {
  const void* prob8;    // (V, D, Hv, Wv, 8) corner cubes, float32 or bf16
  const float* slab8;   // (V, Hv, Wv, 8) 2 x 2 corners x (near, far)
  const float* intr;    // (V, 4, 4)
  const float* c2w;     // (V, 4, 4)
  int prob_bf16;
  int V, D, Hv, Wv;
  int group;            // lanes per sample: min(V, 32)
  float u_scale, v_scale;
  int inverse_depth;
};

#ifdef COST_MAPPING_TRACE
#define TRACE_BLOCKS 4096
#define TRACE_STAMPS 5
// [block][0] start ns, [1] end ns (globaltimer); [2..4] clock64() deltas:
// the point and the cameras; the slab, the depth's place in it and the
// volume's loads issued; the volume's arrival, the sum and the
// reduction.
__device__ long long g_trace[TRACE_BLOCKS][TRACE_STAMPS];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// The 8 corners of cube `i` of a packed volume (ops/cost_mapping.py:
// corner_cubes), corner (by, bx, bz) at (by * 2 + bx) * 2 + bz, each
// promoted to float32 (a bf16 value exactly).
__device__ __forceinline__ void load_cube(const float* p, long long i,
                                          float* val) {
  const float4* q = reinterpret_cast<const float4*>(p) + 2 * i;
  const float4 lo = __ldg(q), hi = __ldg(q + 1);
  val[0] = lo.x; val[1] = lo.y; val[2] = lo.z; val[3] = lo.w;
  val[4] = hi.x; val[5] = hi.y; val[6] = hi.z; val[7] = hi.w;
}
__device__ __forceinline__ void load_cube(const unsigned short* p,
                                          long long i, float* val) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    val[2 * k] = __uint_as_float(w[k] << 16);
    val[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
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

// A sample's projection into one view: what the slab and volume
// lookups need.
struct Proj {
  float zc, wx, wy;
  int xs, ys, sx, sy;
  bool invalid;
};

// A sample's volume lookup in one view, its loads in flight.
struct Vol {
  float val[8], w[4], wz;
  int sz;
  bool in_x1, in_y1, in_z1, ok;
};

__device__ __forceinline__ Proj project(const CostArgs& a, const float* c,
                                        float x, float y, float z) {
  Proj P;
  const float p0 = x - c[9], p1 = y - c[10], p2 = z - c[11];
  const float pc0 = p0 * c[0] + p1 * c[3] + p2 * c[6];
  const float pc1 = p0 * c[1] + p1 * c[4] + p2 * c[7];
  const float zc = p0 * c[2] + p1 * c[5] + p2 * c[8];
  const float fx = c[12], sk = c[13], cx = c[14], fy = c[15], cy = c[16];
  const float xz = pc0 / zc, yz = pc1 / zc;
  const float v_pix = yz * fy + cy;
  const float u_pix = (xz * fx + cx) + ((v_pix - cy) * sk) / fy;
  float u = u_pix * a.u_scale - 1.0f;
  float vv = v_pix * a.v_scale - 1.0f;
  const bool invalid = (zc < 1e-5f) || (u > 1.001f) || (u < -1.001f) ||
                       (vv > 1.001f) || (vv < -1.001f);
  if (invalid) u = vv = -99.0f;
  const float fxi = unnormalize(u, a.Wv), fyi = unnormalize(vv, a.Hv);
  const int x0 = (int)floorf(fxi), y0 = (int)floorf(fyi);
  P.xs = min(max(x0, 0), a.Wv - 1);
  P.ys = min(max(y0, 0), a.Hv - 1);
  P.sx = x0 - P.xs;
  P.sy = y0 - P.ys;
  P.wx = fxi - (float)x0;
  P.wy = fyi - (float)y0;
  P.zc = zc;
  P.invalid = invalid;
  return P;
}

// The pixel's 2 x 2 x (near, far) block of view v: one 32-byte sector,
// two 16-byte loads, issued here and waited for by start_volume.
__device__ __forceinline__ void load_slab(const CostArgs& a, int v,
                                          const Proj& P, float4* s) {
  const long long pix = ((long long)v * a.Hv + P.ys) * a.Wv + P.xs;
  const float4* nf = reinterpret_cast<const float4*>(a.slab8) + 2 * pix;
  s[0] = __ldg(nf);
  s[1] = __ldg(nf + 1);
}

// The bilinear near/far planes, the depth's place in the slab, and the
// loads of the volume's cube at it.
template <typename T>
__device__ __forceinline__ void start_volume(const CostArgs& a, int v,
                                             const Proj& P, const float4* s,
                                             Vol& C) {
  // The four corners (by, bx) in the order (0, 0), (0, 1), (1, 0),
  // (1, 1); row ys and column xs are in range, a corner past the edge is
  // selected to 0.
  C.in_x1 = P.xs + 1 < a.Wv;
  C.in_y1 = P.ys + 1 < a.Hv;
  const bool inb[4] = {true, C.in_x1, C.in_y1, C.in_x1 && C.in_y1};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    C.w[k] = corner_wgt((k >> 1) - P.sy, P.wy) *
             corner_wgt((k & 1) - P.sx, P.wx);
  const float nv[4] = {s[0].x, s[0].z, s[1].x, s[1].z};
  const float fv[4] = {s[0].y, s[0].w, s[1].y, s[1].w};
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    near = near + (inb[k] ? nv[k] : 0.0f) * C.w[k];
    far = far + (inb[k] ? fv[k] : 0.0f) * C.w[k];
  }
  float zg;
  if (a.inverse_depth) {
    const float far_safe = far < 1e-5f ? 1e-8f : far;
    zg = (2.0f * (1.0f - near / P.zc)) / (1.0f - near / far_safe) - 1.0f;
  } else {
    zg = (2.0f * (P.zc - near)) / (far - near) - 1.0f;
  }
  const bool invalid_f = (near < 1e-5f) || (far < 1e-5f) || (zg > 1.01f) ||
                         (zg < -1.01f) || P.invalid;
  const float zn = unnormalize(invalid_f ? -99.0f : zg, a.D);
  const float z0f = floorf(zn);
  const int z0 = (int)z0f;
  const int zs = min(max(z0, 0), a.D - 1);
  C.sz = z0 - zs;
  C.wz = zn - z0f;
  C.in_z1 = zs + 1 < a.D;
  C.ok = !invalid_f;
  // The cube's 8 corners: one sector (16 bytes of bf16, 32 of float32).
  load_cube(static_cast<const T*>(a.prob8),
            (((long long)v * a.D + zs) * a.Hv + P.ys) * a.Wv + P.xs, C.val);
}

// The trilinear sum, in the order (by, bx, bz).
__device__ __forceinline__ float finish_volume(const Vol& C) {
  const bool inb[4] = {true, C.in_x1, C.in_y1, C.in_x1 && C.in_y1};
  float cost = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int bz = 0; bz < 2; ++bz) {
      const bool in = inb[k] && (bz == 0 || C.in_z1);
      cost = cost + (in ? C.val[2 * k + bz] : 0.0f) *
                        (C.w[k] * corner_wgt(bz - C.sz, C.wz));
    }
  }
  return cost;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cost_mapping_kernel(CostArgs a, const float* __restrict__ xyz,
                    const float* __restrict__ onehot, int n,
                    float* __restrict__ pj_out, float* __restrict__ pi_out,
                    unsigned char* __restrict__ valid_out) {
  extern __shared__ float cams[];   // V x CAM
  if (blockIdx.y > 0) {             // this block's scene
    const size_t sc = blockIdx.y, cubes = (size_t)a.V * a.Hv * a.Wv;
    a.prob8 = static_cast<const T*>(a.prob8) + sc * cubes * a.D * 8;
    a.slab8 += sc * cubes * 8;
    a.intr += sc * a.V * 16;
    a.c2w += sc * a.V * 16;
    onehot += sc * a.V;
    xyz += sc * n * 3;
    pj_out += sc * n;
    pi_out += sc * n;
    valid_out += sc * n;
  }
#ifdef COST_MAPPING_TRACE
  long long t0 = clock64(), t_slab = 0;
  const long long ns0 = global_ns();
#endif
  const int V = a.V, G = a.group;
  for (int i = threadIdx.x; i < V * CAM; i += THREADS) {
    const int v = i / CAM, k = i - v * CAM;
    const float* E = a.c2w + 16 * v;
    const float* K = a.intr + 16 * v;
    float c;
    if (k < 9) c = E[(k / 3) * 4 + k % 3];          // R[k / 3][k % 3]
    else if (k < 12) c = E[(k - 9) * 4 + 3];        // t
    else if (k == 12) c = K[0];                      // fx
    else if (k == 13) c = K[1];                      // skew
    else if (k == 14) c = K[2];                      // cx
    else if (k == 15) c = K[5];                      // fy
    else if (k == 16) c = K[6];                      // cy
    else c = onehot[v];
    cams[i] = c;
  }
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int spw = 32 / G;                 // samples per warp
  const int slot = lane / G, g = lane - slot * G;
  const int s = warp * spw + slot;
  const bool active = slot < spw && s < n;
  const int sc = active ? s : n - 1;      // every lane loads in range
  const float x = __ldg(xyz + 3 * sc), y = __ldg(xyz + 3 * sc + 1),
              z = __ldg(xyz + 3 * sc + 2);
  __syncthreads();
#ifdef COST_MAPPING_TRACE
  const long long t_point = clock64();
#endif

  const int leader = slot * G;
  float pi = 0.0f, pj = 0.0f;
  bool valid = false;
  for (int v0 = 0; v0 < V; v0 += G) {     // one round when V <= 32
    const int v = min(v0 + g, V - 1);
    const float* c = cams + CAM * v;
    const Proj P = project(a, c, x, y, z);
    float4 sl[2];
    load_slab(a, v, P, sl);
    Vol C;
    start_volume<T>(a, v, P, sl, C);
#ifdef COST_MAPPING_TRACE
    t_slab = clock64();
#endif
    const float cost = finish_volume(C);
    const float w_same = c[17];
    const float a_same = w_same * cost;
    const float a_other = (1.0f - w_same) * cost;
    const int seen = (w_same == 0.0f) && C.ok;
    // The leader sums the views of this round in view order.
    const int cnt = min(G, V - v0);
    for (int j = 0; j < cnt; ++j) {
      const float sj = __shfl_sync(0xffffffffu, a_same, leader + j);
      const float oj = __shfl_sync(0xffffffffu, a_other, leader + j);
      const int vj = __shfl_sync(0xffffffffu, seen, leader + j);
      pi = pi + sj;
      pj = pj + oj;
      valid = valid || vj;
    }
  }
  if (active && g == 0) {
    pj_out[s] = pj;
    pi_out[s] = valid ? pi : 0.0f;
    valid_out[s] = valid ? 1 : 0;
  }
#ifdef COST_MAPPING_TRACE
  if (threadIdx.x == 0 && blockIdx.x < TRACE_BLOCKS) {
    const long long t_end = clock64();
    g_trace[blockIdx.x][0] = ns0;
    g_trace[blockIdx.x][1] = global_ns();
    g_trace[blockIdx.x][2] = t_point - t0;
    g_trace[blockIdx.x][3] = t_slab - t_point;
    g_trace[blockIdx.x][4] = t_end - t_slab;
  }
#endif
}

extern "C" {

// Launches on `stream` for `scenes` scenes of n samples each (args'
// packs and cameras, xyz, onehot, pj, pi and valid each the scenes' one
// after another); valid is written as bytes 0/1. Returns
// cudaGetLastError() (0 on success).
int cost_mapping_launch_scenes(const CostArgs* args, const float* xyz,
                               const float* onehot, int n, int scenes,
                               float* pj, float* pi, unsigned char* valid,
                               cudaStream_t stream) {
  if (n > 0 && scenes > 0) {
    const CostArgs a = *args;
    const long long per_warp = 32 / a.group;
    const long long warps = ((long long)n + per_warp - 1) / per_warp;
    const dim3 blocks((int)((warps * 32 + THREADS - 1) / THREADS), scenes);
    const size_t smem = sizeof(float) * CAM * a.V;
    if (a.prob_bf16)
      cost_mapping_kernel<unsigned short><<<blocks, THREADS, smem, stream>>>(
          a, xyz, onehot, n, pj, pi, valid);
    else
      cost_mapping_kernel<float><<<blocks, THREADS, smem, stream>>>(
          a, xyz, onehot, n, pj, pi, valid);
  }
  return (int)cudaGetLastError();
}

// One scene.
int cost_mapping_launch(const CostArgs* args, const float* xyz,
                        const float* onehot, int n, float* pj, float* pi,
                        unsigned char* valid, cudaStream_t stream) {
  return cost_mapping_launch_scenes(args, xyz, onehot, n, 1, pj, pi, valid,
                                    stream);
}

const char* cost_mapping_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The trace of the last traced launch (COST_MAPPING_TRACE builds only):
// `blocks` rows of 5 stamps into `dst`. Returns the cudaError_t.
int cost_mapping_trace(long long* dst, int blocks) {
#ifdef COST_MAPPING_TRACE
  if (blocks > TRACE_BLOCKS) blocks = TRACE_BLOCKS;
  return (int)cudaMemcpyFromSymbol(dst, g_trace,
                                   sizeof(long long) * TRACE_STAMPS * blocks);
#else
  (void)dst;
  (void)blocks;
  return (int)cudaErrorNotSupported;
#endif
}

}  // extern "C"
