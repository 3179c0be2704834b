// Fused edge selection: kNN by distance, then Gumbel-top-k over the rest.
//
// Replaces the TPU kernel dfmdock_tpu/ops/select_topk.py:select_topk_fused
// (bodies `_kernel`, `_extract_topk`): iterated max extraction, ties to the
// lower index, so that the picks equal a stable descending sort.  The TPU
// kernel did the neighbour-validity lookup as a one-hot product; here it is
// a load of node_mask at the extracted index.
//
// Bound: bytes.  Per row it reads the N distances and N values of y once
// (3.6 KB at N = 448) and writes K = 60 indices and mask values; the
// extraction's compares stay in shared memory.
//
// Design: one block per (pose, row).  The row's masked -dist lives in shared
// memory twice: once as read (for the kth-distance exclusion of phase 2) and
// once as the working copy that extraction suppresses.  Each extraction is a
// block-wide argmax over (value, -index): a scan of the thread's lanes, a
// warp shuffle, one more across the warps.  y is read once from device
// memory, when phase 2 builds its working copy; log() never runs here, so
// the kernel only compares values that torch computed.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // masked lane, as ops/select_topk.py

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The lowest index of the maximum of s_x[0:N]; every thread gets it, and its
// value lands in *value.  Ends with the block synchronised.
__device__ int block_argmax(const float* s_x, int N, float* s_val, int* s_idx, float* value) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = INT32_MAX;
  for (int l = threadIdx.x; l < N; l += kThreads) {
    const float v = s_x[l];
    if (better(v, l, bv, bi)) {
      bv = v;
      bi = l;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? s_val[lane] : -INFINITY;
    bi = lane < kWarps ? s_idx[lane] : INT32_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_val[kWarps] = bv;
      s_idx[kWarps] = bi;
    }
  }
  __syncthreads();
  *value = s_val[kWarps];
  return s_idx[kWarps];
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ dist, const float* __restrict__ y,
                   const unsigned char* __restrict__ node_mask, int N, int knn, int sample,
                   int* __restrict__ idx, float* __restrict__ edge_mask) {
  extern __shared__ float s_row[];  // masked -dist as read | working copy
  __shared__ float s_val[kWarps + 1];
  __shared__ int s_idx[kWarps + 1];
  __shared__ int s_valid;
  float* s_neg = s_row;
  float* s_work = s_row + N;
  const int64_t row = blockIdx.x;  // pose * N + i
  const int i = (int)(row % N);
  const int K = knn + sample;
  if (threadIdx.x == 0) s_valid = 0;
  __syncthreads();
  int count = 0;
  for (int l = threadIdx.x; l < N; l += kThreads) {
    const bool ok = node_mask[l] != 0;
    const float v = ok ? -dist[row * N + l] : kNegInf;
    s_neg[l] = v;
    s_work[l] = v;
    count += ok;
  }
  atomicAdd(&s_valid, count);  // integer: exact in any order
  __syncthreads();
  const int n = s_valid;
  const bool row_ok = node_mask[i] != 0;
  const int n_knn = min(n, knn), n_samp = min(max(n - knn, 0), sample);

  float kth = 0.0f;
  for (int t = 0; t < K; ++t) {
    if (t == knn) {  // phase 2: Gumbel top-k over the lanes outside the kNN
      for (int l = threadIdx.x; l < N; l += kThreads)
        s_work[l] = s_neg[l] < kth ? y[row * N + l] : kNegInf;
      __syncthreads();
    }
    float value;
    const int best = block_argmax(s_work, N, s_val, s_idx, &value);
    if (t == knn - 1) kth = value;
    if (threadIdx.x == 0) {
      s_work[best] = -INFINITY;  // below every input
      const bool slot_ok = t < knn ? t < n_knn : (t - knn) < n_samp;
      idx[row * K + t] = best;
      edge_mask[row * K + t] = (row_ok && slot_ok && node_mask[best] != 0) ? 1.0f : 0.0f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int select_topk_launch(const float* dist, const float* y,
                                  const unsigned char* node_mask, int P, int N, int knn,
                                  int sample, int* idx, float* edge_mask, void* stream) {
  const int64_t rows = (int64_t)P * N;
  if (rows > 0)
    select_topk_kernel<<<(unsigned)rows, kThreads, 2 * N * sizeof(float),
                         (cudaStream_t)stream>>>(dist, y, node_mask, N, knn, sample, idx,
                                                 edge_mask);
  return (int)cudaGetLastError();
}
