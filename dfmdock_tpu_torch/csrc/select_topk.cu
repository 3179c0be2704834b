// Fused edge selection: kNN by distance, then Gumbel-top-k over the rest.
//
// Replaces the TPU kernel dfmdock_tpu/ops/select_topk.py:select_topk_fused
// (bodies `_kernel`, `_extract_topk`): iterated max extraction, ties to the
// lower index, so that the picks equal a stable descending sort.  The TPU
// kernel did the neighbour-validity lookup as a one-hot product; here it is
// a shared-memory load of node_mask at the extracted index.
//
// Bound: bytes.  Per row it reads the N distances and N values of y once
// (3.6 KB at N = 448) and writes K = 60 indices and mask values; the
// selection itself is O(N) compares per row and phase.  What held the
// block-per-row design back was latency: 60 block-wide extractions a row,
// each with three block barriers and two shuffle trees.
//
// Design: one warp per row, four rows per block, and no block barrier
// inside a selection.  Values become order-preserving 32-bit keys (-0 and
// +0 one key, as they compare equal), so an argmax is two warp reductions
// in hardware (__reduce_max_sync on the key, then __reduce_min_sync on the
// index among the lanes holding it): ties go to the lower index.  The warp
// reads its row coalesced (16 B a lane) into its own slice of shared
// memory, laid out [N / 32][33] so that lane l owns the elements l, l + 32,
// ... in its own bank, and keeps the best of them.  Nothing is overwritten:
// elements leave in the extraction order, so after each extraction only
// the winner's lane needs a new best, the best of its elements ranked below
// the winner, which the whole warp finds in one step (one element a lane,
// conflict-free thanks to the padding) and two more reductions.  The row
// as read stays intact for phase 2, which rewrites it once to
// where(masked_neg < kth, y, -1e30), as the plain version does (lanes tying
// the kth value are excluded too).  Slot t is held by lane t mod 32 and
// stored with its 31 neighbours in one coalesced write; node_mask and the
// count of valid nodes are taken once per block.  y is read only when
// sample > 0; log() never runs here, so the kernel only compares values
// that torch computed (NaN has no place in the key order).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no index
constexpr float kNegInf = -1e30f;  // masked lane, as ops/select_topk.py

// Order-preserving key of a float: a < b exactly when key(a) < key(b), for
// every non-NaN pair; -0 maps to +0's key.  Every key is above 0.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Shared-memory word of element e of a row: [N / 32][33], lane e % 32's
// elements in bank e % 32 + e / 32 (mod 32).
__device__ __forceinline__ int slot_of(int e) { return (e >> 5) * 33 + (e & 31); }

// The best (key, index) of this lane's elements lane, lane + 32, ... in
// s_row: the largest key, the lowest index among equal keys.
__device__ __forceinline__ void lane_best(const unsigned* s_row, int N, int lane, unsigned& bu,
                                          unsigned& bi) {
  bu = 0u;
  bi = kNone;
  for (int e = lane, j = 0; e < N; e += 32, ++j) {
    const unsigned u = s_row[33 * j + lane];
    if (u > bu) {  // indices rise along the loop: a tie keeps the lower
      bu = u;
      bi = e;
    }
  }
}

// The warp's best (key, index) over the lanes' (u, i): every lane gets it.
__device__ __forceinline__ void warp_best(unsigned u, unsigned i, unsigned& mu, unsigned& mi) {
  mu = __reduce_max_sync(kFull, u);
  mi = __reduce_min_sync(kFull, u == mu ? i : kNone);
}

// Slots base .. t of a row, one per lane: the index lane `lane` holds and
// its validity (the row's node, the slot's place among the valid nodes, the
// neighbour's node), in one coalesced store.
__device__ __forceinline__ void store_slots(int* idx_row, float* em_row, int base, int t,
                                            int lane, int my_idx, bool row_ok, int knn,
                                            int n_knn, int n_samp,
                                            const unsigned char* s_mask) {
  const int slot = base + lane;
  if (slot > t) return;
  const bool slot_ok = slot < knn ? slot < n_knn : (slot - knn) < n_samp;
  idx_row[slot] = my_idx;
  em_row[slot] = (row_ok && slot_ok && s_mask[my_idx]) ? 1.0f : 0.0f;
}

// kWide: N > 1024, so a lane holds more than 32 elements and the winner's
// lane has more elements than the warp has lanes.  The looped search at
// every N gives the same picks but took 0.0472 ms device against 0.0359 at
// P = 16, N = 448 on an H100 SXM (700 W; chip_smoke.py), so N <= 1024
// keeps its own instance.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ dist, const float* __restrict__ y,
                   const unsigned char* __restrict__ node_mask, int64_t rows, int N, int knn,
                   int sample, int* __restrict__ idx, float* __restrict__ edge_mask) {
  extern __shared__ unsigned s_dyn[];  // kWarps rows of V x 33 keys | node_mask
  const int V = (N + 31) >> 5;  // elements a lane
  unsigned char* s_mask = reinterpret_cast<unsigned char*>(s_dyn + kWarps * V * 33);
  int n = 0;  // valid nodes: the same count in every thread
  for (int base = 0; base < N; base += kThreads) {
    const int l = base + threadIdx.x;
    const bool ok = l < N && node_mask[l] != 0;
    if (l < N) s_mask[l] = ok;
    n += __syncthreads_count(ok);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;  // pose * N + i
  if (row >= rows) return;  // no block barrier follows
  unsigned* s_row = s_dyn + warp * V * 33;
  const bool vec = (N & 3) == 0;  // rows 16-byte aligned

  // phase 1 keys: masked -dist
  const float* drow = dist + row * N;
  if (vec) {
    for (int l = 4 * lane; l < N; l += 128) {  // l..l+3 share a 32-element column
      const float4 d = *reinterpret_cast<const float4*>(drow + l);
      unsigned* dst = s_row + slot_of(l);
      dst[0] = key_of(s_mask[l] ? -d.x : kNegInf);
      dst[1] = key_of(s_mask[l + 1] ? -d.y : kNegInf);
      dst[2] = key_of(s_mask[l + 2] ? -d.z : kNegInf);
      dst[3] = key_of(s_mask[l + 3] ? -d.w : kNegInf);
    }
  } else {
    for (int l = lane; l < N; l += 32) s_row[slot_of(l)] = key_of(s_mask[l] ? -drow[l] : kNegInf);
  }
  __syncwarp();

  const int K = knn + sample;
  const bool row_ok = s_mask[row % N] != 0;
  const int n_knn = min(n, knn), n_samp = min(max(n - knn, 0), sample);
  const unsigned masked_key = key_of(kNegInf);
  unsigned bu, bi;
  lane_best(s_row, N, lane, bu, bi);
  unsigned kth = 0u;
  int my_idx = 0;
  int* idx_row = idx + row * K;
  float* em_row = edge_mask + row * K;
  for (int t = 0; t < K; ++t) {
    if (t == knn) {  // phase 2: Gumbel top-k over the lanes outside the kNN
      __syncwarp();  // the last step of phase 1 has read the row
      const float* yrow = y + row * N;
      if (vec) {
        for (int l = 4 * lane; l < N; l += 128) {
          const float4 yv = *reinterpret_cast<const float4*>(yrow + l);
          unsigned* dst = s_row + slot_of(l);
          dst[0] = dst[0] < kth ? key_of(yv.x) : masked_key;
          dst[1] = dst[1] < kth ? key_of(yv.y) : masked_key;
          dst[2] = dst[2] < kth ? key_of(yv.z) : masked_key;
          dst[3] = dst[3] < kth ? key_of(yv.w) : masked_key;
        }
      } else {
        for (int l = lane; l < N; l += 32) {
          unsigned* dst = s_row + slot_of(l);
          *dst = *dst < kth ? key_of(yrow[l]) : masked_key;
        }
      }
      __syncwarp();
      lane_best(s_row, N, lane, bu, bi);
    }
    unsigned mu, mi;
    warp_best(bu, bi, mu, mi);
    // the winner's lane w gets the best of its elements ranked below the
    // winner: element w + 32 j looked at by lane j (mod 32)
    const int w = (int)(mi & 31);
    unsigned cu = 0u, ci = kNone;
    if (kWide) {
      for (int j = lane; j < V; j += 32) {
        const int e = w + 32 * j;
        if (e < N) {
          const unsigned u = s_row[33 * j + w];
          if ((u < mu || (u == mu && (unsigned)e > mi)) && u > cu) {
            cu = u;
            ci = e;
          }
        }
      }
    } else {
      const int e = w + 32 * lane;
      if (e < N) {
        const unsigned u = s_row[33 * lane + w];
        if (u < mu || (u == mu && (unsigned)e > mi)) {
          cu = u;
          ci = e;
        }
      }
    }
    unsigned nu, ni;
    warp_best(cu, ci, nu, ni);
    if (lane == w) {
      bu = nu;
      bi = ni;
    }
    if (t == knn - 1) kth = mu;
    if ((t & 31) == lane) my_idx = (int)mi;
    if ((t & 31) == 31 || t == K - 1)
      store_slots(idx_row, em_row, t & ~31, t, lane, my_idx, row_ok, knn, n_knn, n_samp, s_mask);
  }
}

}  // namespace

extern "C" int select_topk_launch(const float* dist, const float* y,
                                  const unsigned char* node_mask, int P, int N, int knn,
                                  int sample, int* idx, float* edge_mask, void* stream) {
  const int64_t rows = (int64_t)P * N;
  if (rows <= 0) return 0;
  const size_t smem = (size_t)kWarps * ((N + 31) / 32) * 33 * sizeof(unsigned) + N;
  const auto kernel = N > 1024 ? select_topk_kernel<true> : select_topk_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      dist, y, node_mask, rows, N, knn, sample, idx, edge_mask);
  return (int)cudaGetLastError();
}
