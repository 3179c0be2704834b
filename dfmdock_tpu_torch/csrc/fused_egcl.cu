// One E_GCL edge pipeline per (pose, node): gather, edge MLP, attention
// gate, masked K-sum, and on the last layer the coord MLP and its K-sum.
//
// Replaces the TPU kernel dfmdock_tpu/ops/fused_egcl.py:fused_edge_layer
// (bodies `_kernel`, `_kernel_coord`, shared `_message_chain`).  The TPU
// version gathered B[j] and the embedding rows with one-hot matrix products
// and split f32 operands into bf16 pieces; here the gathers are plain loads
// and every product is an f32 FMA.
//
// Bound: operations.  Per edge the [C] x [C, C] product with W_l1 (and W_c0
// on the coord layer) is 2 C^2 FLOPs; at N = 448, K = 60, C = 256 that is
// 3.5 GFLOP per pose per product, against ~0.5 MB of inputs per pose.
//
// Design: one block of C threads per (pose, node i); thread c owns output
// column c for all K edges, so the K accumulators live in registers.  The
// K x C message tile (61 KB at K = 60, C = 256) sits in dynamic shared
// memory and is read as float4 broadcasts, one 16-byte load per four FMAs;
// the weight column streams from L2, where W (256 KB) stays resident.
// Masked edges leave the sums by selection, never by multiplying with 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 64;     // edge rows held per block
constexpr int MAX_C = 256;   // threads per block = C
constexpr int EBIN = 5, EGEO = 4;
constexpr int E_DB = 0, E_OB = 1, E_TB = 2, E_PB = 3, E_RP = 4;
constexpr int OMEGA_OFFSET = 40, THETA_OFFSET = 64, PHI_OFFSET = 88;
constexpr int G_RAD = 0, G_CD = 1;

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r] = sum_k s_in[r][k] * W[k][c] for all KMAX rows (rows >= K are
// padding whose results are never read).
__device__ __forceinline__ void rows_times_w(const float* s_in, const float* __restrict__ W,
                                             int C, int c, float (&acc)[KMAX]) {
#pragma unroll
  for (int r = 0; r < KMAX; ++r) acc[r] = 0.0f;
  for (int k = 0; k < C; k += 4) {
    const float w0 = __ldg(W + (k + 0) * C + c);
    const float w1 = __ldg(W + (k + 1) * C + c);
    const float w2 = __ldg(W + (k + 2) * C + c);
    const float w3 = __ldg(W + (k + 3) * C + c);
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(s_in + r * C + k);
      float a = acc[r];
      a = fmaf(v.x, w0, a);
      a = fmaf(v.y, w1, a);
      a = fmaf(v.z, w2, a);
      a = fmaf(v.w, w3, a);
      acc[r] = a;
    }
  }
}

// out[r] = sum_c s_in[r][c] * w[c] for r < K, one warp per row.
__device__ __forceinline__ void row_dots(const float* s_in, const float* __restrict__ w, int C,
                                         int K, float* out, float bias, int mode) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < K; r += nwarps) {
    float s = 0.0f;
    for (int cc = lane; cc < C; cc += 32) s += s_in[r * C + cc] * (w ? w[cc] : 1.0f);
    s = warp_sum(s);
    if (lane == 0) {
      s += bias;
      out[r] = mode == 0 ? 1.0f / (1.0f + expf(-s)) : fminf(fmaxf(s, -2.0f), 2.0f);
    }
  }
}

template <bool COORD>
__global__ void __launch_bounds__(MAX_C)
fused_egcl_kernel(const int* __restrict__ idx, const float* __restrict__ edge_mask,
                  const int* __restrict__ ebin, const float* __restrict__ egeo,
                  const float* __restrict__ a, const float* __restrict__ B,
                  const float* __restrict__ t_sp, const float* __restrict__ t_p,
                  const float* __restrict__ w_r, const float* __restrict__ w_l1,
                  const float* __restrict__ b_l1, const float* __restrict__ w_att,
                  const float* __restrict__ b_att, const float* __restrict__ w_c0,
                  const float* __restrict__ b_c0, const float* __restrict__ w_c1,
                  float* __restrict__ agg, float* __restrict__ trans, int N, int K, int C) {
  extern __shared__ float4 smem4[];
  float* s_buf = reinterpret_cast<float*>(smem4);            // [KMAX][C]
  int* s_bin = reinterpret_cast<int*>(s_buf + KMAX * C);      // [KMAX][EBIN]
  int* s_j = s_bin + KMAX * EBIN;                             // [KMAX]
  int* s_valid = s_j + KMAX;                                  // [KMAX]
  float* s_geo = reinterpret_cast<float*>(s_valid + KMAX);    // [KMAX][EGEO]
  float* s_gate = s_geo + KMAX * EGEO;                        // [KMAX]
  float* s_w = s_gate + KMAX;                                 // [KMAX]

  const int64_t row = blockIdx.x;  // pose * N + i
  const int64_t pose_base = (row / N) * N;
  const int c = threadIdx.x;

  // per-edge fields of this node; padding rows are invalid edges to node 0
  for (int t = c; t < KMAX * EBIN; t += blockDim.x)
    s_bin[t] = t < K * EBIN ? ebin[row * K * EBIN + t] : 0;
  for (int t = c; t < KMAX * EGEO; t += blockDim.x)
    s_geo[t] = t < K * EGEO ? egeo[row * K * EGEO + t] : 0.0f;
  for (int t = c; t < KMAX; t += blockDim.x) {
    s_j[t] = t < K ? idx[row * K + t] : 0;
    s_valid[t] = t < K ? (edge_mask[row * K + t] > 0.5f ? 1 : 0) : 0;
    s_gate[t] = 0.0f;
  }
  __syncthreads();

  // 1. pre = a_i + B[j] + T_sp[4 bins] + T_p[relpos] + radial * w_r; silu
  const float a_c = a[row * C + c], wr_c = w_r[c];
  for (int r = 0; r < KMAX; ++r) {
    float v = 0.0f;
    if (r < K) {
      const int* eb = s_bin + r * EBIN;
      v = a_c + B[(pose_base + s_j[r]) * C + c];
      v += t_sp[eb[E_DB] * C + c];
      v += t_sp[(OMEGA_OFFSET + eb[E_OB]) * C + c];
      v += t_sp[(THETA_OFFSET + eb[E_TB]) * C + c];
      v += t_sp[(PHI_OFFSET + eb[E_PB]) * C + c];
      v += t_p[eb[E_RP] * C + c];
      v = fmaf(s_geo[r * EGEO + G_RAD], wr_c, v);
      v = silu(v);
    }
    s_buf[r * C + c] = v;
  }
  __syncthreads();

  // 2. m2 = silu(pre @ W_l1 + b_l1)
  float acc[KMAX];
  rows_times_w(s_buf, w_l1, C, c, acc);
  __syncthreads();
  const float bl1 = b_l1[c];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) s_buf[r * C + c] = silu(acc[r] + bl1);
  __syncthreads();

  // 3. gate = sigmoid(m2 . w_att + b_att)
  row_dots(s_buf, w_att, C, K, s_gate, b_att[0], 0);
  __syncthreads();

  // 4. agg = sum_k valid ? gate * m2 : 0   (the coord branch keeps m2g)
  float sum = 0.0f;
  for (int r = 0; r < K; ++r) {
    const float g = s_buf[r * C + c] * s_gate[r];
    if (COORD) s_buf[r * C + c] = g;
    if (s_valid[r]) sum += g;
  }
  agg[row * C + c] = sum;
  if (!COORD) return;
  __syncthreads();

  // 5. w = clip(silu(m2g @ W_c0 + b_c0) . w_c1, +-2);  trans = sum valid ? w * cdn : 0
  rows_times_w(s_buf, w_c0, C, c, acc);
  __syncthreads();
  const float bc0 = b_c0[c], wc1 = w_c1[c];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) s_buf[r * C + c] = silu(acc[r] + bc0) * wc1;
  __syncthreads();
  row_dots(s_buf, nullptr, C, K, s_w, 0.0f, 1);
  __syncthreads();
  if (c < 3) {
    float t = 0.0f;
    for (int r = 0; r < K; ++r)
      if (s_valid[r]) t += s_w[r] * s_geo[r * EGEO + G_CD + c];
    trans[row * 3 + c] = t;
  }
}

size_t smem_bytes(int C) {
  return sizeof(float) * KMAX * C + sizeof(int) * KMAX * (EBIN + 2) +
         sizeof(float) * KMAX * (EGEO + 2);
}

template <bool COORD>
int launch(const int* idx, const float* edge_mask, const int* ebin, const float* egeo,
           const float* a, const float* B, const float* t_sp, const float* t_p,
           const float* w_r, const float* w_l1, const float* b_l1, const float* w_att,
           const float* b_att, const float* w_c0, const float* b_c0, const float* w_c1,
           float* agg, float* trans, int P, int N, int K, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(fused_egcl_kernel<COORD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)P * N;
  if (blocks > 0)
    fused_egcl_kernel<COORD><<<(unsigned)blocks, C, smem, stream>>>(
        idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1, w_att, b_att, w_c0,
        b_c0, w_c1, agg, trans, N, K, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_egcl_launch(const int* idx, const float* edge_mask, const int* ebin,
                                 const float* egeo, const float* a, const float* B,
                                 const float* t_sp, const float* t_p, const float* w_r,
                                 const float* w_l1, const float* b_l1, const float* w_att,
                                 const float* b_att, const float* w_c0, const float* b_c0,
                                 const float* w_c1, float* agg, float* trans, int P, int N,
                                 int K, int C, int coord, void* stream) {
  if (K < 1 || K > KMAX || C < 32 || C > MAX_C || C % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (coord)
    return launch<true>(idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1, w_att,
                        b_att, w_c0, b_c0, w_c1, agg, trans, P, N, K, C, s);
  return launch<false>(idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1, w_att,
                       b_att, w_c0, b_c0, w_c1, agg, trans, P, N, K, C, s);
}
