// Pair energy head: masked mean over (i, j) of w2 . silu(LN(hr_i + hl_j)).
//
// Replaces the TPU kernel dfmdock_tpu/ops/energy_head.py:fused_energy (body
// `_kernel`), which evaluated every pair of a row block and accumulated one
// masked sum and one count across the sequential grid in a VMEM tile.
// Blocks here run in parallel and in no order, so each block writes its own
// partial sums and a second pass adds them per pose in a fixed order: no
// float atomics, the same bits each run.
//
// Bound: the pair mask read once and, of hr and hl, only the rows that
// keep a pair (no other row is read), against the special-function work:
// one exp and one reciprocal per channel per kept pair.  On the dock path
// the mask keeps ~2% of the pairs (receptor x ligand within 20 A), crowded
// into the interface rows of a few poses, so the bytes are little more
// than the mask and the special-function units bind, on the reranker
// dock's inputs and more so at dense masks.  A design that waits on one
// mask load per pair, or leaves a row's pairs to one warp, loses to
// latency.
//
// Design: one block of eight warps per (pose, two rows).  The block reads
// its rows of the mask once, coalesced, 16 B a lane, in windows of 1024
// entries; each lane marks its kept entries, a warp scan and a block prefix
// turn the marks into a list of the kept (row, j) in row-major order in
// shared memory, so a block whose rows keep nothing costs its read and two
// barriers.  The list is dealt out to the eight warps in turn.  At C = 256
// (the model's width) eight lanes evaluate one pair, four pairs per warp at
// once: each lane holds 32 channels (float4 loads, 128 B per group) and
// each reduction over C is three shuffle rounds.  Other widths put the
// lanes over C, two pairs per warp.  hr_i, hl_j (one pose's hl is 458 KB at
// N = 448, C = 256: L2), the LN affine and w2 come through the read-only
// cache; silu's exp and division run on the special-function units
// (__expf, __fdividef).  The sum order is fixed by (pose, rows, window,
// list position), whatever the scheduling.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                  // rows of one pose per block
constexpr int kWindow = 4 * kThreads;     // mask entries per window, 4 a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLnEps = 1e-5f;

// The sum over the lanes of each group of `width` neighbouring lanes.
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.0f + __expf(-y)); }

// The kept pairs of a window at C = 256, the model's width: eight lanes per
// pair, so a warp evaluates four pairs at once and each reduction over C
// takes three shuffle rounds.  Lane l of a group holds the channels
// 32 h + 4 l + q (h < 8, q < 4) and loads them as float4, 128 B per group
// and h.  Warp w takes the list entries 4 w .. 4 w + 3, then 32 further.
__device__ __forceinline__ void eval_pairs_256(const int* s_ent, const float* s_m, int total,
                                               int warp, int lane, const float* hr_rows,
                                               const float* hl_pose, const float* g,
                                               const float* b, const float* w2, float& num) {
  constexpr int C = 256;
  const int grp = lane >> 3, l4 = 4 * (lane & 7);
  for (int base = 4 * warp; base < total; base += 4 * kWarps) {
    const int k = base + grp;
    const int ent = s_ent[k < total ? k : base];  // past the list: repeat the first
    const float* hr_i = hr_rows + (ent % kRows) * C + l4;
    const float* hl_j = hl_pose + (ent / kRows) * C + l4;
    float x[32];
    float s = 0.0f;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(hr_i + 32 * h));
      const float4 c = __ldg(reinterpret_cast<const float4*>(hl_j + 32 * h));
      x[4 * h] = a.x + c.x;
      x[4 * h + 1] = a.y + c.y;
      x[4 * h + 2] = a.z + c.z;
      x[4 * h + 3] = a.w + c.w;
#pragma unroll
      for (int q = 0; q < 4; ++q) s += x[4 * h + q];
    }
    const float mean = group_sum<8>(s) * (1.0f / C);
    float sq = 0.0f;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      x[v] -= mean;
      sq += x[v] * x[v];
    }
    const float rs = rsqrtf(group_sum<8>(sq) * (1.0f / C) + kLnEps);
    float e = 0.0f;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int c = 32 * h + l4;
      const float4 gg = __ldg(reinterpret_cast<const float4*>(g + c));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(b + c));
      const float4 ww = __ldg(reinterpret_cast<const float4*>(w2 + c));
      e += ww.x * silu(x[4 * h] * rs * gg.x + bb.x);
      e += ww.y * silu(x[4 * h + 1] * rs * gg.y + bb.y);
      e += ww.z * silu(x[4 * h + 2] * rs * gg.z + bb.z);
      e += ww.w * silu(x[4 * h + 3] * rs * gg.w + bb.w);
    }
    e = group_sum<8>(e);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the four pairs in list order, in every lane
      const float eq = __shfl_sync(kFull, e, 8 * q);
      if (base + q < total) num += eq * s_m[base + q];
    }
  }
}

// The kept pairs of a window at any C <= 1024 (a multiple of 32): the lanes
// over C (channel lane + 32 v), two pairs per warp at a time.  Warp w takes
// the list entries w and w + 8, then 16 further.
__device__ __forceinline__ void eval_pairs_any(const int* s_ent, const float* s_m, int total,
                                               int warp, int lane, int C,
                                               const float* hr_rows, const float* hl_pose,
                                               const float* g, const float* b,
                                               const float* w2, float& num) {
  constexpr int kMaxV = 32, kPairs = 2;
  const int per_lane = C >> 5;
  const float inv_c = 1.0f / (float)C;
  for (int base = warp; base < total; base += kWarps * kPairs) {
    float x[kPairs][kMaxV], s[kPairs], e[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int k = base + p * kWarps;
      const int ent = s_ent[k < total ? k : base];  // past the list: repeat the first
      const float* hr_i = hr_rows + (ent % kRows) * C;
      const float* hl_j = hl_pose + (ent / kRows) * C;
      s[p] = 0.0f;
#pragma unroll
      for (int v = 0; v < kMaxV; ++v) {
        if (v < per_lane) {
          x[p][v] = __ldg(hr_i + lane + 32 * v) + __ldg(hl_j + lane + 32 * v);
          s[p] += x[p][v];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const float mean = group_sum<32>(s[p]) * inv_c;
      s[p] = 0.0f;
#pragma unroll
      for (int v = 0; v < kMaxV; ++v) {
        if (v < per_lane) {
          x[p][v] -= mean;
          s[p] += x[p][v] * x[p][v];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      s[p] = rsqrtf(group_sum<32>(s[p]) * inv_c + kLnEps);
      e[p] = 0.0f;
    }
#pragma unroll
    for (int v = 0; v < kMaxV; ++v) {
      if (v < per_lane) {
        const int c = lane + 32 * v;
        const float gc = __ldg(g + c), bc = __ldg(b + c), wc = __ldg(w2 + c);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) e[p] += wc * silu(x[p][v] * s[p] * gc + bc);
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      e[p] = group_sum<32>(e[p]);
      const int k = base + p * kWarps;
      if (k < total) num += e[p] * s_m[k];
    }
  }
}

// k256: C == 256 (eval_pairs_256), else eval_pairs_any.
template <bool k256>
__global__ void __launch_bounds__(kThreads)
energy_rows_kernel(const float* __restrict__ hr, const float* __restrict__ hl,
                   const float* __restrict__ mask, const float* __restrict__ g,
                   const float* __restrict__ b, const float* __restrict__ w2, int N, int C,
                   float* __restrict__ partial) {
  __shared__ int s_ent[kWindow];  // kept entries of the window: kRows j + r
  __shared__ float s_m[kWindow];  // and their mask values
  __shared__ int s_cnt[kWarps];
  __shared__ float s_num[kWarps], s_den[kWarps];
  const int tile = blockIdx.x, pose = blockIdx.y;
  const int i0 = tile * kRows;
  const int len = min(kRows, N - i0) * N;  // the block's mask entries, contiguous
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mrows = mask + ((int64_t)pose * N + i0) * N;
  const float* hr_rows = hr + ((int64_t)pose * N + i0) * C;
  const float* hl_pose = hl + (int64_t)pose * N * C;
  const bool vec = (N & 3) == 0;  // rows 16-byte aligned
  float num = 0.0f, den = 0.0f;
  for (int w0 = 0; w0 < len; w0 += kWindow) {
    const int e0 = w0 + 4 * threadIdx.x;
    float m[4];
    if (vec && e0 < len) {
      const float4 q = *reinterpret_cast<const float4*>(mrows + e0);
      m[0] = q.x;
      m[1] = q.y;
      m[2] = q.z;
      m[3] = q.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) m[q] = e0 + q < len ? mrows[e0 + q] : 0.0f;
    }
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cnt += m[q] != 0.0f;
      den += m[q];
    }
    int incl = cnt;  // inclusive scan over the warp's lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_cnt[warp] = incl;
    __syncthreads();  // also: the last window's list has been read
    int off = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w];
      off += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (m[q] != 0.0f) {
        const int e = e0 + q, r = e / N;  // row i0 + r, column e - r N
        s_ent[off] = kRows * (e - r * N) + r;
        s_m[off] = m[q];
        ++off;
      }
    }
    __syncthreads();
    if (k256)
      eval_pairs_256(s_ent, s_m, total, warp, lane, hr_rows, hl_pose, g, b, w2, num);
    else
      eval_pairs_any(s_ent, s_m, total, warp, lane, C, hr_rows, hl_pose, g, b, w2, num);
  }
  den = group_sum<32>(den);
  if (lane == 0) {
    s_num[warp] = num;  // the same in every lane
    s_den[warp] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, d = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += s_num[w];
      d += s_den[w];
    }
    const int64_t at = (int64_t)pose * gridDim.x + tile;
    partial[at * 2] = a;
    partial[at * 2 + 1] = d;
  }
}

// One block per pose: the block partials summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
energy_reduce_kernel(const float* __restrict__ partial, int tiles, float* __restrict__ out) {
  __shared__ float s_num[kThreads], s_den[kThreads];
  const float* part = partial + (int64_t)blockIdx.x * tiles * 2;
  float a = 0.0f, d = 0.0f;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
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

// partial holds P x ceil(N / 2) x 2 floats (ops/energy_head.ROWS_PER_BLOCK).
extern "C" int energy_head_launch(const float* hr, const float* hl, const float* mask,
                                  const float* g, const float* b, const float* w2, int P,
                                  int N, int C, float* partial, float* out, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (N + kRows - 1) / kRows;
  if (N > 0) {
    const dim3 grid(tiles, P);
    if (C == 256)  // the model's width
      energy_rows_kernel<true><<<grid, kThreads, 0, s>>>(hr, hl, mask, g, b, w2, N, C, partial);
    else
      energy_rows_kernel<false><<<grid, kThreads, 0, s>>>(hr, hl, mask, g, b, w2, N, C, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  energy_reduce_kernel<<<P, kThreads, 0, s>>>(partial, tiles, out);
  return (int)cudaGetLastError();
}
