// Per-step edge table for the EGCL layers: one thread per edge.
//
// Replaces the TPU kernel dfmdock_tpu/ops/edge_table.py:build_edge_table
// (body `_kernel`), which gathered node geometry with one-hot matrix
// products and evaluated atan with a polynomial; here the gathers are plain
// loads and the trig is libdevice's atan2f/acosf.  The bins-only entry
// point (edge_bins_launch, the same code without the geometry stores)
// replaces the parked TPU kernel dfmdock_tpu/ops/edge_bins.py:edge_bins
// (body `_kernel`): the five bins of an edge are the same bits either way.
//
// Bound: bytes.  Per edge it reads idx (4 B) and two 36 B backbone rows
// (L1/L2 resident: one pose's pos is 16 KB at N = 448), and writes five
// int32 bins and four f32 of geometry (36 B; the bins-only mode 20 B); a
// few hundred FLOPs per edge do not approach the card's rate.
//
// The arithmetic follows the plain version (ops/edge_table.py
// build_edge_table_plain) operation for operation, so bins agree except
// where an angle or distance lies within rounding of a bin boundary.  NaN
// angles arise only on degenerate pairs (i == j, or padded rows at the
// origin); they fail every boundary comparison and land in bin 0, as in the
// plain version, and every float output stays finite.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDistBounds = 39, kAngleBounds = 23, kPhiBounds = 11;
constexpr float kSpatialCutoff = 22.0f;
constexpr float kDeg = 57.29577951308232f;  // 180 / pi
constexpr int kMaxRelative = 32;
constexpr int kBins = 5;  // per edge: dist, omega, theta, phi bin, relpos class
constexpr float kCbA = -0.58273431f, kCbB = 0.56802827f, kCbC = -0.54067466f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// virtual C-beta from backbone N/CA/C (trRosetta coefficients)
__device__ __forceinline__ V3 virtual_cb(V3 n, V3 ca, V3 c) {
  V3 b = sub(ca, n), c_ = sub(c, ca), a = cross(b, c_);
  return {kCbA * a.x + kCbB * b.x + kCbC * c_.x + ca.x,
          kCbA * a.y + kCbB * b.y + kCbC * c_.y + ca.y,
          kCbA * a.z + kCbB * b.z + kCbC * c_.z + ca.z};
}

__device__ float dihedral_deg(V3 a, V3 b, V3 c, V3 d) {
  V3 b1 = sub(a, b), b2 = sub(b, c), b3 = sub(c, d);
  V3 n1 = cross(b1, b2);
  n1 = divs(n1, norm(n1));
  V3 n2 = cross(b2, b3);
  n2 = divs(n2, norm(n2));
  V3 m1 = cross(n1, divs(b2, norm(b2)));
  return atan2f(dot(m1, n2), dot(n1, n2)) * kDeg;
}

__device__ __forceinline__ int bin_of(float x, const float* bounds, int nb) {
  int count = 0;
  for (int b = 0; b < nb; ++b) count += (x > bounds[b]) ? 1 : 0;
  return count;
}

// kGeo: also write the EGNN geometry (radial, coord-diff) of every edge.
template <bool kGeo>
__global__ void edge_table_kernel(const int* __restrict__ idx, const float* __restrict__ pos,
                                  const int* __restrict__ res_id,
                                  const int* __restrict__ asym_id, const float* __restrict__ bounds,
                                  int P, int N, int K, int normalize, int* __restrict__ ebin,
                                  float* __restrict__ egeo) {
  __shared__ float s_bounds[kDistBounds + kAngleBounds + kPhiBounds];
  for (int b = threadIdx.x; b < kDistBounds + kAngleBounds + kPhiBounds; b += blockDim.x)
    s_bounds[b] = bounds[b];
  __syncthreads();

  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)P * N * K) return;
  const int64_t row = e / K;  // p * N + i
  const int i = (int)(row % N);
  const int64_t pose = row / N;
  const int j = idx[e];

  const float* pi = pos + row * 9;
  const float* pj = pos + (pose * N + j) * 9;
  V3 n_i = load3(pi), ca_i = load3(pi + 3), c_i = load3(pi + 6);
  V3 n_j = load3(pj), ca_j = load3(pj + 3), c_j = load3(pj + 6);
  V3 cb_i = virtual_cb(n_i, ca_i, c_i), cb_j = virtual_cb(n_j, ca_j, c_j);

  V3 diff = sub(ca_i, ca_j);
  float rad = dot(diff, diff);
  float dist = sqrtf(fmaxf(rad, 1e-12f));
  float omega = dihedral_deg(ca_i, cb_i, cb_j, ca_j);
  float theta = dihedral_deg(n_i, ca_i, cb_i, cb_j);
  V3 v1 = sub(ca_i, cb_i), v2 = sub(cb_j, cb_i);
  float phi = acosf(dot(v1, v2) / (norm(v1) * norm(v2))) * kDeg;

  const float* db_b = s_bounds;
  const float* ang_b = s_bounds + kDistBounds;
  const float* phi_b = s_bounds + kDistBounds + kAngleBounds;
  bool keep = (dist < kSpatialCutoff) && (j != i);
  int db = bin_of(dist, db_b, kDistBounds);
  int ob = keep ? bin_of(omega, ang_b, kAngleBounds) : 0;
  int tb = keep ? bin_of(theta, ang_b, kAngleBounds) : 0;
  int pb = keep ? bin_of(phi, phi_b, kPhiBounds) : 0;

  int rp;
  if (asym_id[i] == asym_id[j]) {
    int off = res_id[i] - res_id[j] + kMaxRelative;
    rp = min(max(off, 0), 2 * kMaxRelative);
  } else {
    rp = 2 * kMaxRelative + 1;
  }

  int* out_b = ebin + e * kBins;
  out_b[0] = db;
  out_b[1] = ob;
  out_b[2] = tb;
  out_b[3] = pb;
  out_b[4] = rp;
  if (kGeo) {
    if (normalize) diff = divs(diff, sqrtf(rad + 1e-8f) + 1.0f);
    reinterpret_cast<float4*>(egeo)[e] = make_float4(rad, diff.x, diff.y, diff.z);
  }
}

template <bool kGeo>
int launch(const int* idx, const float* pos, const int* res_id, const int* asym_id,
           const float* bounds, int P, int N, int K, int normalize, int* ebin, float* egeo,
           void* stream) {
  const int64_t edges = (int64_t)P * N * K;
  const int threads = 256;
  const int64_t blocks = (edges + threads - 1) / threads;
  if (blocks > 0)
    edge_table_kernel<kGeo><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        idx, pos, res_id, asym_id, bounds, P, N, K, normalize, ebin, egeo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edge_table_launch(const int* idx, const float* pos, const int* res_id,
                                 const int* asym_id, const float* bounds,
                                 int P, int N, int K, int normalize, int* ebin, float* egeo,
                                 void* stream) {
  return launch<true>(idx, pos, res_id, asym_id, bounds, P, N, K, normalize, ebin, egeo,
                      stream);
}

extern "C" int edge_bins_launch(const int* idx, const float* pos, const int* res_id,
                                const int* asym_id, const float* bounds, int P, int N, int K,
                                int* ebin, void* stream) {
  return launch<false>(idx, pos, res_id, asym_id, bounds, P, N, K, 0, ebin, nullptr, stream);
}
