// Per-step edge table for the EGCL layers: one warp per row i, its lanes
// over the row's K edges, 32 at a time.
//
// Replaces the TPU kernel dfmdock_tpu/ops/edge_table.py:218 `_kernel` (the
// body of build_edge_table), which gathered node geometry with one-hot
// matrix products and evaluated atan with a polynomial; here the gathers are
// plain loads and the trig is libdevice's atan2f/acosf.  The bins-only
// entry point (edge_bins_launch, the same code without the geometry stores)
// replaces the parked TPU kernel dfmdock_tpu/ops/edge_bins.py:74 `_kernel`:
// the five bins of an edge are the same bits either way.
//
// What bounds it on an H100: not bytes.  The function moves 40 B per edge
// (idx in, five int32 bins and four f32 of geometry out; the bins-only mode
// 24 B), ~17.5 MB at the dock's 430,080 edges.  An edge kept for the angles
// takes two atan2f, one acosf, six square roots and a dozen IEEE divisions:
// several hundred instructions, so those edges are bound by instruction
// throughput; every edge also gathers its neighbour's backbone (36 B at a
// random row) and waits on it.  The design cuts the instructions and the
// waits:
// - A warp per row, on a (row tile, pose) grid, so no index is divided: the
//   row's own terms (its virtual C-beta, theta's n1 and m1, the shared
//   b = ca_i - cb_i and its norm) are evaluated once per row instead of once
//   per edge, with the same expressions, so they give the same bits.  Terms
//   an edge's angles share are taken once: omega's b2 is theta's b3 and,
//   negated, phi's v2 (the same norm, bit for bit).
// - Bins by index arithmetic instead of 39 + 23 + 23 + 11 compares: a guess
//   from (x - b(0)) / step, then moved over the boundaries until
//   b(g-1) < x <= b(g).  The moves are unbounded, so the bin is exactly
//   count(x > b) whatever the guess.  The dist and phi boundaries are exact
//   in float32 and computed; the angle table is copied into shared memory
//   by each warp while the row's terms are computed (no block barrier).
// - Dropped edges (dist >= 22 A or j == i) skip omega, theta and phi:
//   their angle bins are 0 either way.
// - The next 32 edges' neighbours are loaded one pass ahead; the bins of 32
//   edges are staged in shared memory and written 16 B a lane (coalesced);
//   the geometry is one float4 per edge.
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
constexpr int kWarps = 4;  // rows per block

// The boundaries of features/sixd.py as float32, ascending.  dist
// 3.25 + 1.25 g and phi 18 g are exact in float32 and computed where they
// are compared; the angle boundaries, jnp.linspace(-180, 180, 23) in
// float32, follow no float32 formula and are read from a table.
__device__ const float kAngleTable[kAngleBounds] = {
    -180.0f, -163.63636779785156f, -147.27272033691406f, -130.90908813476562f,
    -114.54544830322266f, -98.18182373046875f, -81.81817626953125f, -65.45454406738281f,
    -49.090911865234375f, -32.727272033691406f, -16.363628387451172f,
    -1.9073486328125e-06f, 16.36363983154297f, 32.727272033691406f, 49.09090805053711f,
    65.45454406738281f, 81.81818389892578f, 98.18182373046875f, 114.54545593261719f,
    130.90908813476562f, 147.27273559570312f, 163.63636779785156f, 180.0f,
};
// 1 / step of each family: the guess only, the moves make the bin exact
constexpr float kDistInvStep = 0.8f, kAngleInvStep = 22.0f / 360.0f, kPhiInvStep = 1.0f / 18.0f;

struct DistBound {
  __device__ float operator()(int g) const { return 3.25f + 1.25f * (float)g; }
};
struct PhiBound {
  __device__ float operator()(int g) const { return 18.0f * (float)g; }
};
struct AngleBound {
  const float* table;  // a copy in shared memory
  __device__ float operator()(int g) const { return table[g]; }
};

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

// atan2 of a dihedral's (y, x) = (m1 . n2, n1 . n2) with n2 the unit normal
// of (b2, b3), in degrees: the last steps of dihedral_deg(a, b, c, d)
// (b1 = a - b, b2 = b - c, b3 = c - d) once n1 and m1 are known.
__device__ __forceinline__ float dihedral_tail(V3 n1, V3 m1, V3 b2, V3 b3) {
  V3 n2 = cross(b2, b3);
  n2 = divs(n2, norm(n2));
  return atan2f(dot(m1, n2), dot(n1, n2)) * kDeg;
}

// count(x > b(g)) over the nb ascending boundaries b(0) .. b(nb - 1) (b(nb)
// read as +inf): a guess from (x - b(0)) * inv_step, then moved until
// b(g-1) < x <= b(g).  The moves have no bound, so the count is exact
// whatever the guess; NaN and x <= b(0) give 0.
template <class Bound>
__device__ __forceinline__ int bin_of(float x, Bound b, int nb, float inv_step) {
  const float lo = b(0);
  if (!(x > lo)) return 0;
  int g = 1 + (int)fminf((x - lo) * inv_step, (float)(nb - 1));
  while (g < nb && x > b(g)) ++g;
  while (!(x > b(g - 1))) --g;
  return g;
}

// kGeo: also write the EGNN geometry (radial, coord-diff) of every edge.
// One warp per row: block (x, p) takes rows x * kWarps + warp of pose p,
// the lanes the row's edges 32 at a time.
template <bool kGeo>
__global__ void __launch_bounds__(kWarps * 32)
edge_table_kernel(const int* __restrict__ idx, const float* __restrict__ pos,
                  const int* __restrict__ res_id, const int* __restrict__ asym_id, int N,
                  int K, int normalize, int* __restrict__ ebin, float* __restrict__ egeo) {
  __shared__ float s_angle[kWarps][32];
  __shared__ __align__(16) int s_bins[kWarps][32 * kBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;
  // loaded now and stored after the row's terms: the angle table (a copy
  // per warp)
  const float angle_b = kAngleTable[min(lane, kAngleBounds - 1)];
  const int64_t row = (int64_t)blockIdx.y * N + i;  // p * N + i
  const float* pos_p = pos + (int64_t)blockIdx.y * N * 9;  // the row's pose

  // the row's own terms, once for all of its edges
  const float* pi = pos_p + i * 9;
  const V3 ca_i = load3(pi + 3);
  const V3 cb_i = virtual_cb(load3(pi), ca_i, load3(pi + 6));
  // omega's b1, theta's b2 and phi's v1 are all ca_i - cb_i
  const V3 b_i = sub(ca_i, cb_i);
  const float b_i_norm = norm(b_i);
  V3 th_n1 = cross(sub(load3(pi), ca_i), b_i);  // theta's n1 and m1
  th_n1 = divs(th_n1, norm(th_n1));
  const V3 th_m1 = cross(th_n1, divs(b_i, b_i_norm));
  const int asym_i = asym_id[i], res_i = res_id[i];
  s_angle[warp][lane] = angle_b;
  __syncwarp();
  const AngleBound angle{s_angle[warp]};

  int* s_b = s_bins[warp];
  int j_next = lane < K ? idx[row * K + lane] : 0;  // the first 32 edges'
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const int j = j_next;
    if (k + 32 < K) j_next = idx[row * K + k + 32];  // the next 32 edges'
    if (k < K) {
      const int64_t e = row * K + k;
      const float* pj = pos_p + j * 9;
      const V3 ca_j = load3(pj + 3);
      const V3 cb_j = virtual_cb(load3(pj), ca_j, load3(pj + 6));

      V3 diff = sub(ca_i, ca_j);
      const float rad = dot(diff, diff);
      const float dist = sqrtf(fmaxf(rad, 1e-12f));
      const int db = bin_of(dist, DistBound{}, kDistBounds, kDistInvStep);
      int ob = 0, tb = 0, pb = 0;
      if (dist < kSpatialCutoff && j != i) {
        // omega = dihedral(ca_i, cb_i, cb_j, ca_j): b1 = b_i, b2 = cb_i - cb_j
        const V3 b2 = sub(cb_i, cb_j);
        const float b2_norm = norm(b2);
        V3 n1 = cross(b_i, b2);
        n1 = divs(n1, norm(n1));
        const V3 m1 = cross(n1, divs(b2, b2_norm));
        const float omega = dihedral_tail(n1, m1, b2, sub(cb_j, ca_j));
        // theta = dihedral(n_i, ca_i, cb_i, cb_j): b2 = b_i, b3 = omega's b2
        const float theta = dihedral_tail(th_n1, th_m1, b_i, b2);
        // phi = angle(ca_i, cb_i, cb_j): v1 = b_i, v2 = cb_j - cb_i (= -b2,
        // whose norm is b2's bit for bit)
        const float phi = acosf(dot(b_i, sub(cb_j, cb_i)) / (b_i_norm * b2_norm)) * kDeg;
        ob = bin_of(omega, angle, kAngleBounds, kAngleInvStep);
        tb = bin_of(theta, angle, kAngleBounds, kAngleInvStep);
        pb = bin_of(phi, PhiBound{}, kPhiBounds, kPhiInvStep);
      }
      int rp;
      if (asym_i == asym_id[j]) {
        rp = min(max(res_i - res_id[j] + kMaxRelative, 0), 2 * kMaxRelative);
      } else {
        rp = 2 * kMaxRelative + 1;
      }
      int* sb = s_b + lane * kBins;
      sb[0] = db;
      sb[1] = ob;
      sb[2] = tb;
      sb[3] = pb;
      sb[4] = rp;
      if (kGeo) {
        if (normalize) diff = divs(diff, sqrtf(rad + 1e-8f) + 1.0f);
        reinterpret_cast<float4*>(egeo)[e] = make_float4(rad, diff.x, diff.y, diff.z);
      }
    }
    __syncwarp();
    // the chunk's bins are contiguous in ebin: 16 B a lane where aligned
    const int count = min(32, K - k0) * kBins;
    int* dst = ebin + (row * K + k0) * kBins;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      const int4* src4 = reinterpret_cast<const int4*>(s_b);
      int4* dst4 = reinterpret_cast<int4*>(dst);
      for (int q = lane; q < count / 4; q += 32) dst4[q] = src4[q];
      for (int q = count / 4 * 4 + lane; q < count; q += 32) dst[q] = s_b[q];
    } else {
      for (int q = lane; q < count; q += 32) dst[q] = s_b[q];
    }
    __syncwarp();
  }
}

// The bin code alone, for tests: out[t] = the bin of x[t] in one family
// (0 dist, 1 angle, 2 phi), as the edge kernel bins its values.
__global__ void bin_values_kernel(const float* __restrict__ x, int n, int family,
                                  int* __restrict__ out) {
  __shared__ float s_angle[kAngleBounds];
  if (threadIdx.x < kAngleBounds) s_angle[threadIdx.x] = kAngleTable[threadIdx.x];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  if (family == 0) {
    out[t] = bin_of(x[t], DistBound{}, kDistBounds, kDistInvStep);
  } else if (family == 1) {
    out[t] = bin_of(x[t], AngleBound{s_angle}, kAngleBounds, kAngleInvStep);
  } else {
    out[t] = bin_of(x[t], PhiBound{}, kPhiBounds, kPhiInvStep);
  }
}

template <bool kGeo>
int launch(const int* idx, const float* pos, const int* res_id, const int* asym_id, int P,
           int N, int K, int normalize, int* ebin, float* egeo, void* stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, P);
  if (P > 0 && N > 0 && K > 0)
    edge_table_kernel<kGeo><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        idx, pos, res_id, asym_id, N, K, normalize, ebin, egeo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edge_table_launch(const int* idx, const float* pos, const int* res_id,
                                 const int* asym_id, int P, int N, int K, int normalize,
                                 int* ebin, float* egeo, void* stream) {
  return launch<true>(idx, pos, res_id, asym_id, P, N, K, normalize, ebin, egeo, stream);
}

extern "C" int edge_bins_launch(const int* idx, const float* pos, const int* res_id,
                                const int* asym_id, int P, int N, int K, int* ebin,
                                void* stream) {
  return launch<false>(idx, pos, res_id, asym_id, P, N, K, 0, ebin, nullptr, stream);
}

extern "C" int edge_bin_values_launch(const float* x, int n, int family, int* out,
                                      void* stream) {
  if (n > 0)
    bin_values_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, n, family, out);
  return (int)cudaGetLastError();
}
