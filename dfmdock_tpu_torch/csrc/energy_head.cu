// Pair energy head: masked mean over (i, j) of w2 . silu(LN(hr_i + hl_j)).
//
// Replaces the TPU kernel dfmdock_tpu/ops/energy_head.py:fused_energy (body
// `_kernel`), which accumulated one masked sum and one count across the
// sequential grid in a VMEM tile.  Blocks here run in parallel and in no
// order, so each block writes its own partial sums and a second pass adds
// them per pose in a fixed order: no float atomics, the same bits each run.
//
// Bound: about as much by bytes (hr, hl and the pair mask read once) as by
// operations (~16 FLOPs per channel per kept pair: the add, two-pass mean
// and variance, normalise, affine, silu, w2 product); which one depends on
// how many pairs the mask keeps.
//
// Design: one block per (pose, row i) holds hr_i, the LN affine and w2 in
// shared memory; each warp takes pairs j in turn with its lanes over C, so
// every reduction over C is a warp shuffle and hl_j is one coalesced read
// (hl of one pose, 458 KB at N = 448, C = 256, stays in L2).  Pairs whose
// mask is 0 are skipped: they add exactly 0 to both sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 32;  // C <= 1024
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
energy_rows_kernel(const float* __restrict__ hr, const float* __restrict__ hl,
                   const float* __restrict__ mask, const float* __restrict__ g,
                   const float* __restrict__ b, const float* __restrict__ w2, int N, int C,
                   float* __restrict__ partial) {
  extern __shared__ float s_vec[];  // hr_i | g | b | w2, C each
  __shared__ float s_num[kWarps], s_den[kWarps];
  const int i = blockIdx.x;
  const int64_t row = (int64_t)blockIdx.y * N + i;
  float* s_hr = s_vec;
  float* s_g = s_vec + C;
  float* s_b = s_vec + 2 * C;
  float* s_w = s_vec + 3 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    s_hr[c] = hr[row * C + c];
    s_g[c] = g[c];
    s_b[c] = b[c];
    s_w[c] = w2[c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_lane = C >> 5;
  const float* mrow = mask + row * N;
  const float* hl_pose = hl + (int64_t)blockIdx.y * N * C;
  float num = 0.0f, den = 0.0f;
  for (int j = warp; j < N; j += kWarps) {
    const float m = mrow[j];  // one address per warp: the branch is uniform
    if (m == 0.0f) continue;
    const float* hl_j = hl_pose + (int64_t)j * C;
    float x[kMaxPerLane];
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxPerLane; ++v) {
      if (v < per_lane) {
        const int c = lane + 32 * v;
        x[v] = s_hr[c] + hl_j[c];
        s += x[v];
      }
    }
    const float mean = warp_sum(s) / (float)C;
    float sq = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxPerLane; ++v) {
      if (v < per_lane) {
        x[v] -= mean;
        sq += x[v] * x[v];
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)C + kLnEps);
    float e = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxPerLane; ++v) {
      if (v < per_lane) {
        const int c = lane + 32 * v;
        const float y = x[v] * rstd * s_g[c] + s_b[c];
        e += s_w[c] * (y / (1.0f + expf(-y)));
      }
    }
    e = warp_sum(e);
    num += e * m;
    den += m;
  }
  if (lane == 0) {
    s_num[warp] = num;
    s_den[warp] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, d = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += s_num[w];
      d += s_den[w];
    }
    partial[row * 2] = a;
    partial[row * 2 + 1] = d;
  }
}

// One block per pose: the N row partials summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
energy_reduce_kernel(const float* __restrict__ partial, int N, float* __restrict__ out) {
  __shared__ float s_num[kThreads], s_den[kThreads];
  const float* part = partial + (int64_t)blockIdx.x * N * 2;
  float a = 0.0f, d = 0.0f;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    a += part[2 * i];
    d += part[2 * i + 1];
  }
  s_num[threadIdx.x] = a;
  s_den[threadIdx.x] = d;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_num[threadIdx.x] += s_num[threadIdx.x + stride];
      s_den[threadIdx.x] += s_den[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s_num[0] / (s_den[0] + 1e-6f);
}

}  // namespace

extern "C" int energy_head_launch(const float* hr, const float* hl, const float* mask,
                                  const float* g, const float* b, const float* w2, int P,
                                  int N, int C, float* partial, float* out, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    energy_rows_kernel<<<dim3(N, P), kThreads, 4 * C * sizeof(float), s>>>(
        hr, hl, mask, g, b, w2, N, C, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  energy_reduce_kernel<<<P, kThreads, 0, s>>>(partial, N, out);
  return (int)cudaGetLastError();
}
