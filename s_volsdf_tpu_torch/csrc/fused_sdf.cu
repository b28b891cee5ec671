// Fused no-grad SDF-MLP forward for Hopper (sm_90a).
//
// Replaces s_volsdf_tpu/ops/pallas/fused_sdf.py::_kernel (the Pallas TPU
// kernel behind fused_sdf_values). For each point it computes the
// positional encoding [x, sin(2^k x), cos(2^k x)], a chain of dense
// layers W = g*v/||v||_0 (materialised by the wrapper) with one skip
// concat [h, pe] * 1/sqrt(2), softplus(100 h)/100 between layers, and
// only column 0 of the last layer (the SDF), clamped by
// sphere_scale * (bounding_sphere - ||x||) when bounding_sphere > 0.
//
// What bounds it on this card: FP32 FMAs and shared-memory loads. At the
// dtu width (9 layers, 256 wide, skip at 4, multires 6) a point costs
// 459,264 multiply-adds (SDF column only), so one sweep of 65,536 points
// is about 60 GFLOP; weights (0.6 MB) stay in L2 and every block streams
// them once per layer. The design answers that simply:
//   * a block takes a tile of TILE_P = 32 points; 256 threads, thread j
//     owns output column j of every hidden layer and keeps the tile's 32
//     accumulators in registers;
//   * activations ping-pong between two 32 x 256 f32 buffers in dynamic
//     shared memory (64 KB; the PE input sits beside them for the skip
//     junction), read as float4 broadcasts so each shared load feeds
//     four FMAs per point;
//   * weight row k is read from global memory once per block, coalesced
//     across j, which is why the wrapper keeps the (in, out) layout;
//   * the last layer computes the SDF column only, as a warp reduction.
// Tensor cores (wgmma with TF32 or bf16 tiles) and TMA-fed weight tiles
// are later work: this kernel is the simple, exact version.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (see s_volsdf_tpu_torch/ops/fused_sdf.py); plain C entry points, bound
// with ctypes.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_LAYERS 16
#define TILE_P 32
#define N_THREADS 256
#define MAX_WIDTH 256   // hidden width and activation row stride
#define PE_STRIDE 64    // room for multires <= 10 (d_pe <= 63)

// Layer table, passed by value. Layer l reads in_pad[l] input columns
// (in_dim[l] real ones, the rest zero) and writes out[l] columns; its
// weights are in_pad[l] x out[l] row-major at params + w_off[l], its
// bias out[l] floats at params + b_off[l]. The last layer is packed as
// its SDF column only (in_pad floats) and its bias[0].
struct SdfMeta {
  int n_layers;
  int skip_layer;   // -1: no skip junction
  int multires;
  int d_pe;         // 3 * (1 + 2 * multires)
  float bounding_sphere;
  float sphere_scale;
  int in_dim[MAX_LAYERS];
  int in_pad[MAX_LAYERS];
  int out[MAX_LAYERS];
  int w_off[MAX_LAYERS];
  int b_off[MAX_LAYERS];
};

__device__ __forceinline__ float softplus100(float h) {
  // jax.nn.softplus form: max(z, 0) + log1p(exp(-|z|)), z = 100 h.
  float z = 100.0f * h;
  return (fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)))) * 0.01f;
}

__global__ void __launch_bounds__(N_THREADS)
fused_sdf_kernel(const float* __restrict__ pts,
                 const float* __restrict__ params,
                 float* __restrict__ out, int n_pts, SdfMeta meta) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf0 = smem;                              // TILE_P x MAX_WIDTH
  float* buf1 = buf0 + TILE_P * MAX_WIDTH;         // TILE_P x MAX_WIDTH
  float* pe = buf1 + TILE_P * MAX_WIDTH;           // TILE_P x PE_STRIDE
  __shared__ float xyz[TILE_P][3];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TILE_P;

  if (tid < TILE_P * 3) {
    int p = tid / 3, c = tid % 3;
    xyz[p][c] = (p0 + p < n_pts) ? pts[(size_t)(p0 + p) * 3 + c] : 0.0f;
  }
  __syncthreads();

  // Positional encoding, zero-padded to PE_STRIDE columns.
  for (int i = tid; i < TILE_P * PE_STRIDE; i += N_THREADS) {
    int p = i / PE_STRIDE, col = i % PE_STRIDE;
    float v = 0.0f;
    if (col < 3) {
      v = xyz[p][col];
    } else if (col < meta.d_pe) {
      int e = col - 3;
      int k = e / 6, r = e % 6;                    // octave, [sin xyz, cos xyz]
      float xk = xyz[p][r % 3] * (float)(1 << k);
      v = (r < 3) ? sinf(xk) : cosf(xk);
    }
    pe[i] = v;
  }
  __syncthreads();

  const float inv_sqrt2 = 0.7071067811865475f;
  const int last = meta.n_layers - 1;
  float* in_buf = pe;
  int in_stride = PE_STRIDE;
  float* nxt = buf0;
  int prev_out = meta.d_pe;

  for (int l = 0; l < meta.n_layers; ++l) {
    const int in_dim = meta.in_dim[l];
    const int in_pad = meta.in_pad[l];
    if (l > 0) {
      // in_buf holds the previous layer's prev_out columns. Add the skip
      // junction [h, pe] * 1/sqrt(2) and zero the padding columns.
      const bool skip = (l == meta.skip_layer);
      for (int i = tid; i < TILE_P * in_pad; i += N_THREADS) {
        int p = i / in_pad, col = i % in_pad;
        float* a = &in_buf[p * in_stride + col];
        if (col >= in_dim) {
          *a = 0.0f;
        } else if (skip) {
          *a = (col < prev_out ? *a : pe[p * PE_STRIDE + col - prev_out])
               * inv_sqrt2;
        }
      }
      __syncthreads();
    }

    if (l == last) {
      // SDF column only: warp w reduces points 4w .. 4w+3 over in_pad.
      const float* w_sdf = params + meta.w_off[l];
      const float b_sdf = params[meta.b_off[l]];
      const int warp = tid >> 5, lane = tid & 31;
      for (int q = 0; q < TILE_P / (N_THREADS / 32); ++q) {
        int p = warp * (TILE_P / (N_THREADS / 32)) + q;
        float s = 0.0f;
        for (int k = lane; k < in_pad; k += 32)
          s += in_buf[p * in_stride + k] * w_sdf[k];
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && p0 + p < n_pts) {
          float sdf = s + b_sdf;
          if (meta.bounding_sphere > 0.0f) {
            float r = sqrtf(xyz[p][0] * xyz[p][0] + xyz[p][1] * xyz[p][1]
                            + xyz[p][2] * xyz[p][2]);
            sdf = fminf(sdf, meta.sphere_scale * (meta.bounding_sphere - r));
          }
          out[p0 + p] = sdf;
        }
      }
      break;
    }

    const int n_out = meta.out[l];
    const int j = tid;
    if (j < n_out) {
      const float* W = params + meta.w_off[l];
      const float bj = params[meta.b_off[l] + j];
      float acc[TILE_P];
#pragma unroll
      for (int p = 0; p < TILE_P; ++p) acc[p] = bj;
      for (int k = 0; k < in_pad; k += 4) {
        const float w0 = W[(size_t)(k + 0) * n_out + j];
        const float w1 = W[(size_t)(k + 1) * n_out + j];
        const float w2 = W[(size_t)(k + 2) * n_out + j];
        const float w3 = W[(size_t)(k + 3) * n_out + j];
#pragma unroll
        for (int p = 0; p < TILE_P; ++p) {
          const float4 h =
              *reinterpret_cast<const float4*>(&in_buf[p * in_stride + k]);
          acc[p] = fmaf(h.x, w0, acc[p]);
          acc[p] = fmaf(h.y, w1, acc[p]);
          acc[p] = fmaf(h.z, w2, acc[p]);
          acc[p] = fmaf(h.w, w3, acc[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < TILE_P; ++p)
        nxt[p * MAX_WIDTH + j] = softplus100(acc[p]);
    }
    __syncthreads();
    prev_out = n_out;
    in_buf = nxt;
    in_stride = MAX_WIDTH;
    nxt = (nxt == buf0) ? buf1 : buf0;
  }
}

extern "C" {

size_t fused_sdf_smem_bytes(void) {
  return sizeof(float) * (2 * TILE_P * MAX_WIDTH + TILE_P * PE_STRIDE);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int fused_sdf_forward(const float* pts, const float* params, float* out,
                      int n_pts, SdfMeta meta, cudaStream_t stream) {
  const size_t smem = fused_sdf_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_sdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_pts > 0) {
    const int blocks = (n_pts + TILE_P - 1) / TILE_P;
    fused_sdf_kernel<<<blocks, N_THREADS, smem, stream>>>(pts, params, out,
                                                          n_pts, meta);
  }
  return (int)cudaGetLastError();
}

const char* fused_sdf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
