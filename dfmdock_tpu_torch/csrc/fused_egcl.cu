// One E_GCL edge pipeline per (pose, node): gather, edge MLP, attention
// gate, masked K-sum, and on the last layer the coord MLP and its K-sum.
//
// Replaces the TPU kernel dfmdock_tpu/ops/fused_egcl.py:fused_edge_layer
// (bodies `_kernel`, `_kernel_coord`, shared `_message_chain`).
//
// Bound: operations.  Per edge the [C] x [C, C] product with W_l1 (and W_c0
// on the coord layer) is 2 C^2 FLOPs: at P = 16, N = 448, K = 60, C = 256
// that is 56 GFLOP per product, against ~36 MB of inputs and outputs.
//
// Two precision modes, two kernels:
// - three passes (the float32 mode, `fused_egcl_kernel`): f32-grade
//   products, designed below;
// - one pass (the bf16 mode, `fused_egcl_bf16_kernel`, its own design after
//   the first): what the TPU kernel computes on its MXU.  a_i, B[j], T_sp
//   and T_p are bf16 values (rounded to nearest) summed in f32 into pre (the
//   radial term stays f32); silu(pre) and m2g are rounded to bf16 and each
//   product is one bf16 pass (W as bf16); bias, silu, the gate, the masked
//   K-sum and the coordinate sum stay f32, as in the TPU kernel.
//
// Design of the three-pass mode, for Hopper's tensor cores (sm_90a):
// - Both products run on `wgmma.mma_async` m64n256k16, bf16 x bf16 -> f32,
//   each in three passes on bf16 pieces, hi.hi + lo.hi + hi.lo with
//   x = hi + lo, hi = bf16_rn(x), lo = bf16_rn(x - hi): the TPU kernel's
//   `_split_f32` / `_dot3`, with a round-to-nearest split.  The dropped
//   lo.lo term leaves ~2^-16 relative per product term: f32-grade.
// - One node's K <= 64 edges are one 64-row tile; rows K..63 and masked
//   edges are written as zero rows and never reach a sum.  A block holds
//   two warpgroups, one node each, so every slice of W serves 128 rows.
// - W (hi + lo, 256 KB of bf16) does not fit in shared memory, so it streams
//   through a three-stage ring in K-slices of 16 rows (16 KB each).  The
//   weight is laid out once per set of weights (ops/fused_egcl.prepare_layer)
//   in the order the slice sits in shared memory (wgmma's no-swizzle K-major
//   core matrices, hi then lo per slice), so each slice is one contiguous
//   bulk copy (`cp.async.bulk`, the TMA engine) completing on an mbarrier;
//   every block reads the same W,
//   which stays in L2.  Thread 0 refills a stage once both warpgroups have
//   released it.  Blocks are persistent: one per SM, walking node pairs.
// - The gather binds before the tensor cores: pre needs six C-wide f32 rows
//   per edge.  So it is cut along K like W and pipelined: `cp.async` copies
//   the rows' 16 columns of slice s + 2 into a staging buffer while slice
//   s + 1 of pre = a_i + B[j] + T_sp[4 bins] + T_p[relpos] + radial * w_r is
//   assembled from the staged rows (silu, then hi / lo pieces into the
//   other of two A slice buffers) and the wgmmas of slice s run.  No register holds a load in flight.  On the
//   layers without the coord MLP the spatial tables (T_sp, 100 KB) sit in
//   shared memory and only B[j] and T_p are staged; the coord layer needs
//   the room for the m2g tile, and stages all six rows.
// - Epilogue in registers: bias and silu on the accumulator, the gate's row
//   dot by quad shuffles, the masked K-sum by shuffles within a warp and a
//   fixed-order sum of the four warps through shared memory: no float
//   atomics, the same bits on every run.  On the coord layer m2g goes back
//   to shared memory as the hi / lo A tile of the second product; then
//   w = clip(silu(.) . w_c1, +-2) and trans = sum_k w * cdn.
// Masked edges leave the sums by selection, never by multiplying with 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 256;                  // channels (wgmma N, and the product depth)
constexpr int ROWS = 64;                // edge rows per node tile (wgmma M)
constexpr int KS = 16;                  // W rows (product depth) per ring stage
constexpr int NSLICE = C / KS;          // slices per product
constexpr int STAGES = 3;
constexpr int PIECE = KS * C;           // bf16 elements of one piece (hi or lo) of a W slice
constexpr int SLICE_BYTES = 2 * PIECE * 2;
constexpr int ASLICE = ROWS * KS;       // bf16 elements of one piece of an A slice buffer
constexpr int TILE = ROWS * C;          // bf16 elements of one piece of a node's A tile
constexpr int THREADS = 256;            // two warpgroups
constexpr int SPATIAL_ROWS = 100;       // rows of T_sp
constexpr int EBIN = 5, EGEO = 4;
constexpr int E_DB = 0, E_OB = 1, E_TB = 2, E_PB = 3, E_RP = 4;
constexpr int OMEGA_OFFSET = 40, THETA_OFFSET = 64, PHI_OFFSET = 88;
constexpr int G_RAD = 0, G_CD = 1;

// no-swizzle K-major operand layout: 8 x 8 core matrices of 128 contiguous
// bytes; LBO steps to the next core matrix along K, SBO to the next 8 rows
constexpr uint32_t LBO = 128;
constexpr uint32_t SBO_TILE = (C / 8) * 128;   // A tile: 32 core matrices per 8 rows
constexpr uint32_t SBO_SLICE = (KS / 8) * 128; // W slice and A slice: 2 per 8 rows

struct Meta {          // per warpgroup: the node's edges
  int bin[ROWS * EBIN];
  int j[ROWS];
  int valid[ROWS];
  float geo[ROWS * EGEO];
  float a[C];          // a_i
  float red[4 * C];    // per-warp column sums
  float w[ROWS];       // coord weight per edge
};

// Staged rows per edge: B[j] and T_p, and on the coord layer the four T_sp
// rows (the other layers read T_sp from shared memory).
constexpr int T_B = 0, T_P = 1, T_SP = 2;
constexpr int staged_tables(bool coord) { return coord ? 6 : 2; }

// Shared memory, in bytes: the W ring; per warpgroup its area (two A slice
// buffers and two staging buffers; on the coord layer the m2g tile later);
// T_sp on the other layers; the two Metas; w_r; the ring's barriers.
template <bool COORD>
struct Layout {
  static constexpr int ring = 0;
  static constexpr int abufs = 2 * 2 * ASLICE * 2;                  // [buf][hi, lo]
  static constexpr int stage_bytes = staged_tables(COORD) * ROWS * KS * 4;
  static constexpr int area = STAGES * SLICE_BYTES;
  static constexpr int area_bytes =
      COORD ? 2 * TILE * 2 : abufs + 2 * stage_bytes;
  static_assert(abufs + 2 * stage_bytes <= area_bytes, "the staging exceeds the area");
  static constexpr int tsp = area + 2 * area_bytes;
  static constexpr int meta = tsp + (COORD ? 0 : SPATIAL_ROWS * C * 4);
  static constexpr int wr = meta + 2 * (int)sizeof(Meta);
  static constexpr int bars = wr + C * 4;
  static constexpr int bytes = bars + 2 * STAGES * 8;
  static_assert(bytes <= 232448, "more shared memory than a block may use");
};

__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// FUSED_EGCL_SPIN_LIMIT (undefined in the package's build): define it in a
// debugging build to make a wait that never ends trap instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
#ifdef FUSED_EGCL_SPIN_LIMIT
  uint32_t spins = 0;
#endif
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
#ifdef FUSED_EGCL_SPIN_LIMIT
    if (++spins > (FUSED_EGCL_SPIN_LIMIT)) __trap();
#endif
  }
}

// one bulk copy of a W slice (hi + lo, or hi alone) into a ring stage,
// completing on `bar`
__device__ __forceinline__ void load_slice(void* dst, const void* src, uint64_t* bar,
                                           uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t sbo) {
  // start address, LBO and SBO in 16-byte units; base offset 0; layout 0 (no swizzle)
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#define D8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256 f32, fragment] += A[64 x 16] . B[16 x 256], both from shared memory
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72),
        D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// element offset of (row r, column k) in a no-swizzle K-major tile that is
// `width` columns wide
__device__ __forceinline__ int core_off(int r, int k, int width) {
  return (((r >> 3) * (width / 8) + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

struct Ring {
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  const uint8_t* w1;   // prepared W_l1: [NSLICE][hi, lo][PIECE] bf16
  const uint8_t* wc;   // prepared W_c0 (coord layer)
  int per_pair;        // slices per node pair: NSLICE x products
  int total;           // slices this block consumes
  int seq;             // next slice to consume

  __device__ __nv_bfloat16* stage(int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * SLICE_BYTES);
  }

  __device__ void issue(int v) {   // thread 0: load slice number v
    if (v >= total) return;
    const int st = v % STAGES;
    if (v >= STAGES) mbar_wait(&empty[st], ((v - STAGES) / STAGES) & 1);
    const int in_pair = v % per_pair;
    const uint8_t* w = in_pair < NSLICE ? w1 : wc;
    load_slice(stage(st), w + (size_t)(in_pair % NSLICE) * SLICE_BYTES, &full[st], SLICE_BYTES);
  }

  // d = A . W over the NSLICE slices, three passes each.  a_at(sl) is the
  // hi piece of slice sl's A columns (lo at +
  // lo_off elements, rows SBO `sbo` apart); between(sl) runs while slice
  // sl's wgmmas are in flight.
  template <class AAt, class Between>
  __device__ void product(float (&d)[128], AAt a_at, int lo_off, uint32_t sbo,
                          Between between) {
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
#pragma unroll 1
    for (int sl = 0; sl < NSLICE; ++sl) {
      const int u = seq++;
      const int st = u % STAGES;
      mbar_wait(&full[st], (u / STAGES) & 1);
      const __nv_bfloat16* a = a_at(sl);
      const __nv_bfloat16* w = stage(st);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const uint64_t ah = desc(a + kk * 128, sbo);
        const uint64_t al = desc(a + lo_off + kk * 128, sbo);
        const uint64_t bh = desc(w + kk * 128, SBO_SLICE);
        const uint64_t bl = desc(w + PIECE + kk * 128, SBO_SLICE);
        wgmma(d, al, bh);
        wgmma(d, ah, bl);
        wgmma(d, ah, bh);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      between(sl);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      mbar_arrive(&empty[st]);
      if (threadIdx.x == 0) issue(u + STAGES);
    }
  }
};

// Slices of pre for one warpgroup's node: `issue` stages the rows' KS
// columns of slice sl (one cp.async group per slice, empty past the last),
// `build` writes slice sl of A = silu(pre) as bf16 hi / lo.  Masked rows are
// neither staged nor read: they are written as 0.
template <bool COORD>
struct Gather {
  static constexpr int NT = staged_tables(COORD);
  const Meta& m;
  const float* wr_s;      // w_r, shared memory
  const float* tsp_s;     // T_sp, shared memory (not on the coord layer)
  const float* B;
  const float* t_sp;
  const float* t_p;
  int64_t pose_base;
  float* stage;           // [2][NT][ROWS][KS] f32
  __nv_bfloat16* abuf;    // [2][hi, lo][ASLICE]
  int tid;

  __device__ const float* row_src(int t, int r) const {
    const int* eb = m.bin + r * EBIN;
    switch (t) {
      case T_B: return B + (pose_base + m.j[r]) * C;
      case T_P: return t_p + eb[E_RP] * C;
      case T_SP: return t_sp + eb[E_DB] * C;
      case T_SP + 1: return t_sp + (OMEGA_OFFSET + eb[E_OB]) * C;
      case T_SP + 2: return t_sp + (THETA_OFFSET + eb[E_TB]) * C;
      default: return t_sp + (PHI_OFFSET + eb[E_PB]) * C;
    }
  }

  __device__ void issue(int sl) const {
    if (sl < NSLICE) {
      float* dst = stage + (sl & 1) * NT * ROWS * KS;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int h = 0; h < ROWS * KS / 4 / 128; ++h) {
          const int chunk = tid + 128 * h, r = chunk / (KS / 4), part = chunk % (KS / 4);
          if (m.valid[r])
            cp_async16(dst + (t * ROWS + r) * KS + 4 * part, row_src(t, r) + sl * KS + 4 * part);
        }
    }
    cp_async_commit();
  }

  // lane = (row of 8, four columns): the 8 lanes of a shared-memory phase
  // read two rows, so T_sp's gathered rows conflict at most two ways
  __device__ void build(int sl, int warp, int lane) const {
    const int quad = lane & 3, c4 = 4 * quad, col = sl * KS + c4;
    __nv_bfloat16* buf = abuf + (sl & 1) * 2 * ASLICE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + 8 * h + (lane >> 2);
      const float* st = stage + (sl & 1) * NT * ROWS * KS + r * KS + c4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (m.valid[r]) {
        const int* eb = m.bin + r * EBIN;
        float4 x[6];
        x[0] = *reinterpret_cast<const float4*>(st + T_B * ROWS * KS);
        if (COORD) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            x[1 + t] = *reinterpret_cast<const float4*>(st + (T_SP + t) * ROWS * KS);
        } else {
          x[1] = *reinterpret_cast<const float4*>(tsp_s + eb[E_DB] * C + col);
          x[2] = *reinterpret_cast<const float4*>(tsp_s + (OMEGA_OFFSET + eb[E_OB]) * C + col);
          x[3] = *reinterpret_cast<const float4*>(tsp_s + (THETA_OFFSET + eb[E_TB]) * C + col);
          x[4] = *reinterpret_cast<const float4*>(tsp_s + (PHI_OFFSET + eb[E_PB]) * C + col);
        }
        x[5] = *reinterpret_cast<const float4*>(st + T_P * ROWS * KS);
        const float4 ai = *reinterpret_cast<const float4*>(m.a + col);
        const float4 wr = *reinterpret_cast<const float4*>(wr_s + col);
        const float rad = m.geo[r * EGEO + G_RAD];
        float4 s = ai;
#pragma unroll
        for (int t = 0; t < 6; ++t) s.x += x[t].x, s.y += x[t].y, s.z += x[t].z, s.w += x[t].w;
        v[0] = silu(fmaf(rad, wr.x, s.x));
        v[1] = silu(fmaf(rad, wr.y, s.y));
        v[2] = silu(fmaf(rad, wr.z, s.z));
        v[3] = silu(fmaf(rad, wr.w, s.w));
      }
      uint2 hi, lo;
      split(v[0], v[1], hi.x, lo.x);
      split(v[2], v[3], hi.y, lo.y);
      const int off = core_off(r, c4, KS);
      *reinterpret_cast<uint2*>(buf + off) = hi;
      *reinterpret_cast<uint2*>(buf + ASLICE + off) = lo;
    }
  }
};

template <bool COORD>
__global__ void __launch_bounds__(THREADS, 1)
fused_egcl_kernel(const int* __restrict__ idx, const float* __restrict__ edge_mask,
                  const int* __restrict__ ebin, const float* __restrict__ egeo,
                  const float* __restrict__ a, const float* __restrict__ B,
                  const float* __restrict__ t_sp, const float* __restrict__ t_p,
                  const float* __restrict__ w_r, const uint8_t* __restrict__ w_l1,
                  const float* __restrict__ b_l1, const float* __restrict__ w_att,
                  const float* __restrict__ b_att, const uint8_t* __restrict__ w_c0,
                  const float* __restrict__ b_c0, const float* __restrict__ w_c1,
                  float* __restrict__ agg, float* __restrict__ trans, int nodes, int N,
                  int K) {
  using L = Layout<COORD>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  __nv_bfloat16* area = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::area + wg * L::area_bytes);
  Meta& m = reinterpret_cast<Meta*>(smem_raw + L::meta)[wg];
  float* wr_s = reinterpret_cast<float*>(smem_raw + L::wr);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + L::bars);
  float* tsp_s = reinterpret_cast<float*>(smem_raw + L::tsp);

  const int pairs = (nodes + 1) / 2;
  const int my_pairs = blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  Ring ring{smem_raw + L::ring, bars, bars + STAGES, w_l1, w_c0,
                    NSLICE * (COORD ? 2 : 1), 0, 0};
  ring.total = my_pairs * ring.per_pair;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&ring.full[st], 1);
      mbar_init(&ring.empty[st], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int t = threadIdx.x; t < C / 4; t += THREADS)
    reinterpret_cast<float4*>(wr_s)[t] = reinterpret_cast<const float4*>(w_r)[t];
  if (!COORD)
    for (int t = threadIdx.x; t < SPATIAL_ROWS * C / 4; t += THREADS)
      reinterpret_cast<float4*>(tsp_s)[t] = __ldg(reinterpret_cast<const float4*>(t_sp) + t);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int v = 0; v < STAGES; ++v) ring.issue(v);

  const float bias_att = b_att[0];
  float d[128];
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int node = 2 * pair + wg;
    const bool live = node < nodes;
    const int64_t row = live ? node : 0;
    const int64_t pose_base = (row / N) * N;

    // 1. the node's edges and a_i; rows K..63, masked edges and a missing
    //    node are invalid
    bar_wg(wg);
    for (int t = tid; t < ROWS; t += 128) {
      const bool ok = live && t < K && edge_mask[row * K + t] > 0.5f;
      m.valid[t] = ok;
      m.j[t] = ok ? idx[row * K + t] : 0;
    }
    for (int t = tid; t < ROWS * EBIN; t += 128)
      m.bin[t] = t < K * EBIN ? ebin[row * K * EBIN + t] : 0;
    for (int t = tid; t < ROWS * EGEO; t += 128)
      m.geo[t] = t < K * EGEO ? egeo[row * K * EGEO + t] : 0.0f;
    if (tid < C / 4)
      reinterpret_cast<float4*>(m.a)[tid] = reinterpret_cast<const float4*>(a + row * C)[tid];
    bar_wg(wg);

    // 2. m2 = silu(silu(pre) . W_l1 + b_l1); the slices of silu(pre) are
    //    built one ahead of the wgmmas and staged two ahead
    const Gather<COORD> g{m, wr_s, tsp_s, B, t_sp, t_p, pose_base,
                          reinterpret_cast<float*>(area + 2 * 2 * ASLICE), area, tid};
    g.issue(0);
    g.issue(1);
    cp_async_wait_one();
    bar_wg(wg);
    g.build(0, warp, lane);
    fence_async_smem();
    bar_wg(wg);
    g.issue(2);
    ring.product(
        d, [&](int sl) { return area + (sl & 1) * 2 * ASLICE; }, ASLICE, SBO_SLICE,
        [&](int sl) {
          if (sl + 1 < NSLICE) {
            cp_async_wait_one();
            bar_wg(wg);
            g.build(sl + 1, warp, lane);
            fence_async_smem();
            bar_wg(wg);
            g.issue(sl + 3);
          }
        });

    // 3. gate = sigmoid(m2 . w_att + b_att)
    const int r_a = 16 * warp + (lane >> 2), r_b = r_a + 8, cq = 2 * (lane & 3);
    float s_a = 0.0f, s_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * i + cq;
      const float2 bb = *reinterpret_cast<const float2*>(b_l1 + c);
      const float2 ww = *reinterpret_cast<const float2*>(w_att + c);
      d[4 * i] = silu(d[4 * i] + bb.x);
      d[4 * i + 1] = silu(d[4 * i + 1] + bb.y);
      d[4 * i + 2] = silu(d[4 * i + 2] + bb.x);
      d[4 * i + 3] = silu(d[4 * i + 3] + bb.y);
      s_a += d[4 * i] * ww.x + d[4 * i + 1] * ww.y;
      s_b += d[4 * i + 2] * ww.x + d[4 * i + 3] * ww.y;
    }
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 1);
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 2);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 1);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 2);
    const float g_a = __fdividef(1.0f, 1.0f + __expf(-(s_a + bias_att)));
    const float g_b = __fdividef(1.0f, 1.0f + __expf(-(s_b + bias_att)));
    const bool v_a = m.valid[r_a], v_b = m.valid[r_b];

    // 4. agg = sum_k valid ? gate * m2 : 0, in a fixed order
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float g = e ? g_b : g_a;
        const bool ok = e ? v_b : v_a;
        d[4 * i + 2 * e] *= g;
        d[4 * i + 2 * e + 1] *= g;
        if (ok) c0 += d[4 * i + 2 * e], c1 += d[4 * i + 2 * e + 1];
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (lane < 4) {
        m.red[warp * C + 8 * i + cq] = c0;
        m.red[warp * C + 8 * i + cq + 1] = c1;
      }
    }
    bar_wg(wg);   // also: every warp's wgmma reads of the A buffers are done
    if (live) {
      const int c = 2 * tid;
      float2 out;
      out.x = ((m.red[c] + m.red[C + c]) + m.red[2 * C + c]) + m.red[3 * C + c];
      out.y = ((m.red[c + 1] + m.red[C + c + 1]) + m.red[2 * C + c + 1]) + m.red[3 * C + c + 1];
      *reinterpret_cast<float2*>(agg + row * C + c) = out;
    }
    if (!COORD) continue;

    // 5. m2g as the A tile of the coord MLP (hi / lo)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * i + cq;
      uint32_t hi, lo;
      split(d[4 * i], d[4 * i + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(area + core_off(r_a, c, C)) = hi;
      *reinterpret_cast<uint32_t*>(area + TILE + core_off(r_a, c, C)) = lo;
      split(d[4 * i + 2], d[4 * i + 3], hi, lo);
      *reinterpret_cast<uint32_t*>(area + core_off(r_b, c, C)) = hi;
      *reinterpret_cast<uint32_t*>(area + TILE + core_off(r_b, c, C)) = lo;
    }
    fence_async_smem();
    bar_wg(wg);

    // 6. w = clip(silu(m2g . W_c0 + b_c0) . w_c1, +-2); trans = sum valid ? w * cdn : 0
    ring.product(
        d, [&](int sl) { return area + core_off(0, sl * KS, C); }, TILE, SBO_TILE,
        [](int) {});
    s_a = 0.0f, s_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * i + cq;
      const float2 bb = *reinterpret_cast<const float2*>(b_c0 + c);
      const float2 ww = *reinterpret_cast<const float2*>(w_c1 + c);
      s_a += silu(d[4 * i] + bb.x) * ww.x + silu(d[4 * i + 1] + bb.y) * ww.y;
      s_b += silu(d[4 * i + 2] + bb.x) * ww.x + silu(d[4 * i + 3] + bb.y) * ww.y;
    }
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 1);
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 2);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 1);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 2);
    if ((lane & 3) == 0) {
      m.w[r_a] = fminf(fmaxf(s_a, -2.0f), 2.0f);
      m.w[r_b] = fminf(fmaxf(s_b, -2.0f), 2.0f);
    }
    bar_wg(wg);
    if (live && tid < 3) {
      float t = 0.0f;
      for (int r = 0; r < K; ++r)
        if (m.valid[r]) t += m.w[r] * m.geo[r * EGEO + G_CD + tid];
      trans[row * 3 + tid] = t;
    }
  }
}

template <bool COORD>
int launch(const int* idx, const float* edge_mask, const int* ebin, const float* egeo,
           const float* a, const float* B, const float* t_sp, const float* t_p,
           const float* w_r, const void* w_l1, const float* b_l1, const float* w_att,
           const float* b_att, const void* w_c0, const float* b_c0, const float* w_c1,
           float* agg, float* trans, int P, int N, int K, cudaStream_t stream) {
  const int smem = Layout<COORD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(fused_egcl_kernel<COORD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int64_t nodes = (int64_t)P * N;
  const int64_t pairs = (nodes + 1) / 2;
  if (nodes > 0)
    fused_egcl_kernel<COORD>
        <<<(unsigned)(pairs < sms ? pairs : sms), THREADS, smem, stream>>>(
        idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r,
        static_cast<const uint8_t*>(w_l1), b_l1, w_att, b_att,
        static_cast<const uint8_t*>(w_c0), b_c0, w_c1, agg, trans, (int)nodes, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 mode: one bf16 pass per product, the TPU kernel's own precision.
// Its own design (the three-pass mode's staging of f32 rows bound it):
// - Staged as bf16.  B reaches the kernel as bf16 (the caller rounds it once
//   per layer) and both embed tables as one bf16 [166][C] array (T_sp, then
//   T_p), which sits in shared memory for the whole launch (rows 576 bytes
//   apart: the two rows that one shared-memory phase reads lie in other
//   banks whenever their indices differ in parity).  Per edge only B[j] is
//   copied, 64 bytes a slice: each thread copies the two 16-byte pieces of
//   B that it will read itself (cp.async, two slices ahead, across node
//   boundaries), into a private staging slot, so no barrier orders them.
//   The next node's edge metadata (idx, mask, bins, geometry, a_i) is
//   copied ahead by cp.async too.
// - A in registers.  Each thread builds its own wgmma A fragment of
//   silu(pre) for rows r and r + 8 and eight columns a slice: one 16-byte
//   load per staged row and table row.  For that the eight columns
//   32 s + 8 q + u of thread q are the fragment's (k-step u / 4, column
//   8 ((u / 2) % 2) + 2 q + u % 2) and W_l1's rows are stored in the same
//   order (ops/fused_egcl.prepare_weight_bf16, build_order=True).  On the
//   coord layer the gated message m2g is the accumulator's fragment, which is
//   already the A fragment of the second product (k-step kk: columns
//   16 kk .. 16 kk + 15), so it never leaves the registers.
// - W, one bf16 piece (128 KB), streams through a five-stage ring in
//   slices of 32 rows (16 KB), refilled once both warpgroups released a
//   stage.  Each block reads W from L2 once per node pair (clusters that
//   share each slice by one multicast copy were measured slower on the
//   H100: PERF.md).
// - silu in the build and the epilogues is the special-function unit's
//   exp2 and reciprocal without __expf's and __fdividef's range fix-ups
//   (silu_approx), the same values in range at fewer instructions.
// - Epilogue in registers: bias, silu and the gate as in the three-pass
//   mode; the masked K-sum as a reduce-scatter over the 16 rows of a warp
//   (32 + 16 + 8 shuffles for 64 columns per thread instead of 192), then
//   the four warps' sums added in a fixed order; the coord update's row
//   sum by shuffles and a fixed-order sum of the warps.  No float atomics.
namespace onepass {

constexpr int KS = 32;                    // W rows (product depth) per ring stage
constexpr int NSL = C / KS;               // slices per product
constexpr int STAGES = 5;
constexpr int SLICE = KS * C * 2;         // bytes of one W slice
constexpr int RELPOS_ROWS = 66;
constexpr int TABLE_ROWS = SPATIAL_ROWS + RELPOS_ROWS;   // T_sp, then T_p
constexpr int ROW_BYTES = C * 2;          // one bf16 row of B or of a table
constexpr int TABLE_STRIDE = ROW_BYTES + 64;
constexpr int BAHEAD = 2;                 // B slices a thread copies ahead of its build
constexpr int BSTAGES = BAHEAD + 1;       // B slices staged per thread
constexpr int BSLOT = THREADS / 2 * 16;   // one 16-byte piece per thread of a warpgroup
constexpr uint32_t SBO_W = (KS / 8) * 128;
// a warpgroup's metadata buffer for one node: raw copies of its edge rows;
// once they are read, the node's per-warp column sums reuse the bytes
constexpr int M_IDX = 0, M_MASK = M_IDX + ROWS * 4, M_BIN = M_MASK + ROWS * 4;
constexpr int M_GEO = M_BIN + ROWS * EBIN * 4, M_A = M_GEO + ROWS * EGEO * 4;
constexpr int META = 4096;
static_assert(M_A + C * 4 <= META && 4 * C * 4 <= META, "a metadata buffer is too small");

struct Layout {
  static constexpr int ring = 0;
  static constexpr int tables = ring + STAGES * SLICE;
  static constexpr int bstage = tables + TABLE_ROWS * TABLE_STRIDE;  // [wg][BSTAGES][2][BSLOT]
  static constexpr int meta = bstage + 2 * BSTAGES * 2 * BSLOT;     // [wg][2][META]
  static constexpr int wr = meta + 2 * 2 * META;
  static constexpr int tpart = wr + C * 4;                          // [wg][4 warps][4]
  static constexpr int bars = tpart + 2 * 4 * 4 * 4;                // full, empty
  static constexpr int bytes = bars + 2 * STAGES * 8;
  static_assert(bytes <= 232448, "more shared memory than a block may use");
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// all but this thread's N newest cp.async groups landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d[64 x 256 f32, fragment] (+)= A[64 x 16] . B[16 x 256]: A from registers
// (the m16n8k16 A fragment of each warp's 16 rows), B from shared memory
__device__ __forceinline__ void wgmma_ra(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72),
        D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// silu(x) = x / (1 + e^-x) with the special-function unit's approximate
// exp2 and reciprocal alone, as __expf and __fdividef compute it in range
// (without their fix-ups for |x| > 87, where this is x or 0 all the same)
__device__ __forceinline__ float silu_approx(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return x * r;
}
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t word(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The W ring, shared by the block's two warpgroups.  Thread 0 issues
// slice v once every warp released slice v - STAGES.
struct Ring {
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  const uint8_t* w1;   // prepared W_l1: [NSL][KS * C] bf16
  const uint8_t* wc;   // prepared W_c0 (coord layer)
  int per_pair;        // slices per node pair: NSL x products
  int total;           // slices this block consumes
  int seq;             // next slice to consume

  __device__ uint8_t* stage(int st) const { return smem + st * SLICE; }

  __device__ void issue(int v) const {
    if (v >= total) return;
    const int st = v % STAGES;
    if (v >= STAGES) mbar_wait(&empty[st], ((v - STAGES) / STAGES) & 1);
    const int in_pair = v % per_pair;
    const uint8_t* w = (in_pair < NSL ? w1 : wc) + (size_t)(in_pair % NSL) * SLICE;
    expect_tx(&full[st], SLICE);
    bulk_copy(stage(st), w, SLICE, &full[st]);
  }

  __device__ int acquire() {
    const int u = seq++;
    mbar_wait(&full[u % STAGES], (u / STAGES) & 1);
    return u;
  }

  // every warp of the block, once its wgmmas on slice u are complete; the
  // warp of thread 0 waits for it to issue before it goes on
  __device__ void release(int u, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[u % STAGES]);
    if (threadIdx.x == 0) issue(u + STAGES);
    __syncwarp();
  }
};

// Slice s of A = silu(pre) for this thread's rows r_a and r_b, columns
// 32 s + 8 q + u, as its wgmma A fragments of the slice's two k-steps:
// pre = a_i + B[j] + T_sp[4 bins] + T_p[relpos] + radial * w_r, the bf16
// values (a_i rounded in shared memory once per node) summed in float32
// in that order (the radial term last, fused).
// A row of a masked edge (table row 0, a stale staging row) is computed
// all the same: a product row depends on its own A row alone, and the
// epilogue drops the row by selection.
__device__ __forceinline__ void build(uint32_t (&frag)[8], int s, int q, const float* ai_s,
                                      const float* wr_s, const uint8_t* bslot,
                                      const uint8_t* tab_s, const int (&off)[2][5],
                                      const float (&rad)[2]) {
  const int col = KS * s + 8 * q;
  const float4 a0 = *reinterpret_cast<const float4*>(ai_s + col);
  const float4 a1 = *reinterpret_cast<const float4*>(ai_s + col + 4);
  const float4 w0 = *reinterpret_cast<const float4*>(wr_s + col);
  const float4 w1 = *reinterpret_cast<const float4*>(wr_s + col + 4);
  const float ai[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float v[2][8];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    uint4 x[6];
    x[0] = *reinterpret_cast<const uint4*>(bslot + e * BSLOT);
#pragma unroll
    for (int t = 0; t < 5; ++t)
      x[1 + t] = *reinterpret_cast<const uint4*>(tab_s + off[e][t] + col * 2);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float sum = ai[u];
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        const uint32_t w = word(x[t], u >> 1);
        sum += (u & 1) ? bf_hi(w) : bf_lo(w);
      }
      v[e][u] = silu_approx(fmaf(rad[e], wr[u], sum));
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    frag[4 * kk] = pack(v[0][4 * kk], v[0][4 * kk + 1]);
    frag[4 * kk + 1] = pack(v[1][4 * kk], v[1][4 * kk + 1]);
    frag[4 * kk + 2] = pack(v[0][4 * kk + 2], v[0][4 * kk + 3]);
    frag[4 * kk + 3] = pack(v[1][4 * kk + 2], v[1][4 * kk + 3]);
  }
}

template <bool COORD>
__global__ void __launch_bounds__(THREADS, 1)
fused_egcl_bf16_kernel(const int* __restrict__ idx, const float* __restrict__ edge_mask,
                       const int* __restrict__ ebin, const float* __restrict__ egeo,
                       const float* __restrict__ a, const __nv_bfloat16* __restrict__ B,
                       const __nv_bfloat16* __restrict__ tables, const float* __restrict__ w_r,
                       const uint8_t* __restrict__ w_l1, const float* __restrict__ b_l1,
                       const float* __restrict__ w_att, const float* __restrict__ b_att,
                       const uint8_t* __restrict__ w_c0, const float* __restrict__ b_c0,
                       const float* __restrict__ w_c1, float* __restrict__ agg,
                       float* __restrict__ trans, int nodes, int N, int K) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int r_a = 16 * warp + (lane >> 2), r_b = r_a + 8;
  const uint8_t* tab_s = smem + Layout::tables;
  uint8_t* bst = smem + Layout::bstage + wg * BSTAGES * 2 * BSLOT + tid * 16;
  uint8_t* meta = smem + Layout::meta + wg * 2 * META;
  const float* wr_s = reinterpret_cast<const float*>(smem + Layout::wr);
  float* tpart = reinterpret_cast<float*>(smem + Layout::tpart) + wg * 16;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::bars);

  // node pairs blockIdx.x, blockIdx.x + gridDim.x, ...; warpgroup wg takes
  // node 2 pair + wg (a missing odd node is dead)
  const int pairs = (nodes + 1) / 2;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int my = blk < pairs ? (pairs - 1 - blk) / nblk + 1 : 0;
  constexpr int PER_PAIR = NSL * (COORD ? 2 : 1);
  Ring ring{smem + Layout::ring, bars, bars + STAGES, w_l1, w_c0, PER_PAIR, my * PER_PAIR, 0};
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&ring.full[st], 1);
      mbar_init(&ring.empty[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int t = threadIdx.x; t < TABLE_ROWS * ROW_BYTES / 16; t += THREADS)
    *reinterpret_cast<uint4*>(smem + Layout::tables + t / (ROW_BYTES / 16) * TABLE_STRIDE +
                              t % (ROW_BYTES / 16) * 16) =
        __ldg(reinterpret_cast<const uint4*>(tables) + t);
  for (int t = threadIdx.x; t < C / 4; t += THREADS)
    reinterpret_cast<float4*>(smem + Layout::wr)[t] =
        __ldg(reinterpret_cast<const float4*>(w_r) + t);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int v = 0; v < STAGES; ++v) ring.issue(v);

  auto node_of = [&](int t) {
    return 2 * (blk + t * nblk) + wg;
  };
  // node t's edge metadata and a_i into buffer t % 2 (one cp.async group)
  auto load_meta = [&](int t) {
    const int node = node_of(t);
    uint8_t* mb = meta + (t & 1) * META;
    if (t < my && node < nodes) {
      const int64_t row = node;
      for (int e = tid; e < K; e += 128) {
        cp_async4(mb + M_IDX + 4 * e, idx + row * K + e);
        cp_async4(mb + M_MASK + 4 * e, edge_mask + row * K + e);
      }
      for (int e = tid; e < K * EBIN; e += 128)
        cp_async4(mb + M_BIN + 4 * e, ebin + row * K * EBIN + e);
      for (int e = tid; e < K * EGEO; e += 128)
        cp_async4(mb + M_GEO + 4 * e, egeo + row * K * EGEO + e);
      if (tid < C / 4) cp_async16(mb + M_A + 16 * tid, a + row * C + 4 * tid);
    }
    cp_async_commit();
  };
  // this thread's rows of node t (metadata landed and visible): where their
  // B rows start (element offsets), -1 for a row that is not a valid edge;
  // and node t's a_i rounded to bf16 in place, two columns a thread
  auto b_rows = [&](int t, int (&boff)[2]) {
    const int node = node_of(t);
    uint8_t* mb = meta + (t & 1) * META;
    float2* ai = reinterpret_cast<float2*>(mb + M_A) + tid;
    *ai = make_float2(rn(ai->x), rn(ai->y));
    const int* j = reinterpret_cast<const int*>(mb + M_IDX);
    const float* mk = reinterpret_cast<const float*>(mb + M_MASK);
    const bool live = t < my && node < nodes;
    const int base = live ? node / N * N : 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = e ? r_b : r_a;
      boff[e] = live && r < K && mk[r] > 0.5f ? (base + j[r]) * C : -1;
    }
  };
  // slice s of the B rows at boff into staging slot `slot` (one group)
  auto stage_b = [&](const int (&boff)[2], int s, int slot) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (boff[e] >= 0)
        cp_async16(bst + (slot * 2 + e) * BSLOT, B + boff[e] + KS * s + 8 * q);
    cp_async_commit();
  };

  int boff[2] = {-1, -1}, bnext[2] = {-1, -1};
  if (my > 0) {
    load_meta(0);
    cp_async_wait<0>();
    bar_wg(wg);
    b_rows(0, boff);
    for (int s = 0; s < BAHEAD; ++s) stage_b(boff, s, s);
  }
  const float bias_att = b_att[0];
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  int bseq = 0;   // B slices consumed so far: slice g sits in slot g % BSTAGES
  for (int t = 0; t < my; ++t) {
    const int node = node_of(t);
    const bool live = node < nodes;
    const int64_t row = live ? node : 0;
    uint8_t* mb = meta + (t & 1) * META;
    bar_wg(wg);   // the last node's sums are read: its buffer takes node t + 1's metadata
    load_meta(t + 1);

    // 1. this thread's two edge rows: validity, table rows, radial (coord diff)
    bool valid[2];
    int off[2][5];
    float rad[2], cdn[2][3];
    {
      const int* eb = reinterpret_cast<const int*>(mb + M_BIN);
      const float* geo = reinterpret_cast<const float*>(mb + M_GEO);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = e ? r_b : r_a;
        const bool ok = boff[e] >= 0;
        const int* b = eb + r * EBIN;
        valid[e] = ok;
        off[e][0] = ok ? b[E_DB] * TABLE_STRIDE : 0;
        off[e][1] = ok ? (OMEGA_OFFSET + b[E_OB]) * TABLE_STRIDE : 0;
        off[e][2] = ok ? (THETA_OFFSET + b[E_TB]) * TABLE_STRIDE : 0;
        off[e][3] = ok ? (PHI_OFFSET + b[E_PB]) * TABLE_STRIDE : 0;
        off[e][4] = ok ? (SPATIAL_ROWS + b[E_RP]) * TABLE_STRIDE : 0;
        rad[e] = ok ? geo[r * EGEO + G_RAD] : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) cdn[e][c] = ok && COORD ? geo[r * EGEO + G_CD + c] : 0.0f;
      }
    }
    const float* ai_s = reinterpret_cast<const float*>(mb + M_A);

    // 2. m2 = silu(silu(pre) . W_l1 + b_l1): slice s + 1 is built while the
    //    wgmmas of slice s run; B is staged BAHEAD slices ahead, the next
    //    node's first during this node's last.  A thread's cp.async groups:
    //    B(t, 0 .. BAHEAD - 1) (staged during node t - 1), the metadata of
    //    node t + 1, then one B slice an iteration.
    uint32_t frag[2][8];
    int u = 0;
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      if (s == NSL - BAHEAD) {
        cp_async_wait<BAHEAD - 1>();   // node t + 1's metadata landed (and B slice s)
        bar_wg(wg);
        b_rows(t + 1, bnext);
      } else if (s < BAHEAD) {
        cp_async_wait<BAHEAD>();   // B slice s (the metadata may be in flight)
      } else {
        cp_async_wait<BAHEAD - 1>();
      }
      if (s + BAHEAD < NSL)
        stage_b(boff, s + BAHEAD, (bseq + s + BAHEAD) % BSTAGES);
      else
        stage_b(bnext, s + BAHEAD - NSL, (bseq + s + BAHEAD) % BSTAGES);
      build(frag[s & 1], s, q, ai_s, wr_s, bst + (bseq + s) % BSTAGES * 2 * BSLOT, tab_s, off,
            rad);
      u = ring.acquire();
      const uint8_t* w = ring.stage(u % STAGES);
      fence_acc(d);
      wgmma_fence();
      wgmma_ra(d, frag[s & 1][0], frag[s & 1][1], frag[s & 1][2], frag[s & 1][3],
               desc(w, SBO_W), s > 0);
      wgmma_ra(d, frag[s & 1][4], frag[s & 1][5], frag[s & 1][6], frag[s & 1][7],
               desc(w + 256, SBO_W), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(d);
      if (s > 0) ring.release(u - 1, lane);
    }
    wgmma_wait<0>();
    fence_acc(d);
    ring.release(u, lane);
    bseq += NSL;
    boff[0] = bnext[0], boff[1] = bnext[1];

    // 3. gate = sigmoid(m2 . w_att + b_att); m2g = gate * m2
    float s_a = 0.0f, s_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * i + 2 * q;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b_l1 + c));
      const float2 ww = __ldg(reinterpret_cast<const float2*>(w_att + c));
      d[4 * i] = silu_approx(d[4 * i] + bb.x);
      d[4 * i + 1] = silu_approx(d[4 * i + 1] + bb.y);
      d[4 * i + 2] = silu_approx(d[4 * i + 2] + bb.x);
      d[4 * i + 3] = silu_approx(d[4 * i + 3] + bb.y);
      s_a += d[4 * i] * ww.x + d[4 * i + 1] * ww.y;
      s_b += d[4 * i + 2] * ww.x + d[4 * i + 3] * ww.y;
    }
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 1);
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 2);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 1);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 2);
    const float g_a = __fdividef(1.0f, 1.0f + __expf(-(s_a + bias_att)));
    const float g_b = __fdividef(1.0f, 1.0f + __expf(-(s_b + bias_att)));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      d[4 * i] *= g_a;
      d[4 * i + 1] *= g_a;
      d[4 * i + 2] *= g_b;
      d[4 * i + 3] *= g_b;
    }

    // 4. agg = sum_k valid ? m2g : 0: each warp's 16 rows by a reduce-scatter
    //    (lane bits 2, 3, 4 halve the columns a lane keeps), then the four
    //    warps in a fixed order
    {
      // the thread's rows' sum of column 8 (t / 2) + 2 q + t % 2, t < 64
#define COL_SUM(t) ((valid[0] ? d[4 * ((t) >> 1) + ((t) & 1)] : 0.0f) + \
                    (valid[1] ? d[4 * ((t) >> 1) + 2 + ((t) & 1)] : 0.0f))
      const bool b1 = lane & 4, b2 = lane & 8, b3 = lane & 16;
      float r1[32], r2[16], r3[8];
#pragma unroll
      for (int t2 = 0; t2 < 32; ++t2) {
        const float x = COL_SUM(t2), y = COL_SUM(32 + t2);
        r1[t2] = (b1 ? y : x) + __shfl_xor_sync(0xffffffffu, b1 ? x : y, 4);
      }
#undef COL_SUM
#pragma unroll
      for (int t2 = 0; t2 < 16; ++t2) {
        const float x = r1[t2], y = r1[16 + t2];
        r2[t2] = (b2 ? y : x) + __shfl_xor_sync(0xffffffffu, b2 ? x : y, 8);
      }
#pragma unroll
      for (int t2 = 0; t2 < 8; ++t2) {
        const float x = r2[t2], y = r2[8 + t2];
        r3[t2] = (b3 ? y : x) + __shfl_xor_sync(0xffffffffu, b3 ? x : y, 16);
      }
      bar_wg(wg);   // every warp's loads of this node's a_i, whose bytes red reuses, are done
      float* red = reinterpret_cast<float*>(mb);
      const int ib = 16 * b1 + 8 * b2 + 4 * b3;
#pragma unroll
      for (int t2 = 0; t2 < 8; t2 += 2)
        *reinterpret_cast<float2*>(red + warp * C + 8 * (ib + (t2 >> 1)) + 2 * q) =
            make_float2(r3[t2], r3[t2 + 1]);
      bar_wg(wg);
      if (live) {
        const int c = 2 * tid;
        float2 out;
        out.x = ((red[c] + red[C + c]) + red[2 * C + c]) + red[3 * C + c];
        out.y = ((red[c + 1] + red[C + c + 1]) + red[2 * C + c + 1]) + red[3 * C + c + 1];
        *reinterpret_cast<float2*>(agg + row * C + c) = out;
      }
    }
    if (!COORD) continue;

    // 5. w = clip(silu(m2g . W_c0 + b_c0) . w_c1, +-2), m2g (bf16) straight
    //    from the accumulator as the A fragments; trans = sum_k valid ? w * cdn : 0
    uint32_t m2g[64];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      m2g[4 * kk] = pack(d[8 * kk], d[8 * kk + 1]);
      m2g[4 * kk + 1] = pack(d[8 * kk + 2], d[8 * kk + 3]);
      m2g[4 * kk + 2] = pack(d[8 * kk + 4], d[8 * kk + 5]);
      m2g[4 * kk + 3] = pack(d[8 * kk + 6], d[8 * kk + 7]);
    }
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      u = ring.acquire();
      const uint8_t* w = ring.stage(u % STAGES);
      fence_acc(d);
      wgmma_fence();
      wgmma_ra(d, m2g[8 * s], m2g[8 * s + 1], m2g[8 * s + 2], m2g[8 * s + 3], desc(w, SBO_W),
               s > 0);
      wgmma_ra(d, m2g[8 * s + 4], m2g[8 * s + 5], m2g[8 * s + 6], m2g[8 * s + 7],
               desc(w + 256, SBO_W), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(d);
      if (s > 0) ring.release(u - 1, lane);
    }
    wgmma_wait<0>();
    fence_acc(d);
    ring.release(u, lane);
    s_a = 0.0f, s_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * i + 2 * q;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b_c0 + c));
      const float2 ww = __ldg(reinterpret_cast<const float2*>(w_c1 + c));
      s_a += silu_approx(d[4 * i] + bb.x) * ww.x +
             silu_approx(d[4 * i + 1] + bb.y) * ww.y;
      s_b += silu_approx(d[4 * i + 2] + bb.x) * ww.x +
             silu_approx(d[4 * i + 3] + bb.y) * ww.y;
    }
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 1);
    s_a += __shfl_xor_sync(0xffffffffu, s_a, 2);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 1);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, 2);
    const float wa = fminf(fmaxf(s_a, -2.0f), 2.0f), wb = fminf(fmaxf(s_b, -2.0f), 2.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float tc = 0.0f;
      if (valid[0]) tc += wa * cdn[0][c];
      if (valid[1]) tc += wb * cdn[1][c];
      tc += __shfl_xor_sync(0xffffffffu, tc, 4);
      tc += __shfl_xor_sync(0xffffffffu, tc, 8);
      tc += __shfl_xor_sync(0xffffffffu, tc, 16);
      if (lane == 0) tpart[warp * 4 + c] = tc;
    }
    bar_wg(wg);
    if (live && tid < 3)
      trans[row * 3 + tid] = ((tpart[tid] + tpart[4 + tid]) + tpart[8 + tid]) + tpart[12 + tid];
  }
}

template <bool COORD>
int launch(const int* idx, const float* edge_mask, const int* ebin, const float* egeo,
           const float* a, const void* B, const void* tables, const float* w_r,
           const void* w_l1, const float* b_l1, const float* w_att, const float* b_att,
           const void* w_c0, const float* b_c0, const float* w_c1, float* agg, float* trans,
           int P, int N, int K, cudaStream_t stream) {
  const auto kernel = fused_egcl_bf16_kernel<COORD>;
  constexpr int smem = Layout::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int64_t nodes = (int64_t)P * N;
  const int64_t pairs = (nodes + 1) / 2;
  if (nodes > 0)
    kernel<<<(unsigned)(pairs < sms ? pairs : sms), THREADS, smem, stream>>>(
        idx, edge_mask, ebin, egeo, a, static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(tables), w_r, static_cast<const uint8_t*>(w_l1), b_l1,
        w_att, b_att, static_cast<const uint8_t*>(w_c0), b_c0, w_c1, agg, trans, (int)nodes, N,
        K);
  return (int)cudaGetLastError();
}

}  // namespace onepass

}  // namespace

// The three-pass float32 mode.  w_l1 / w_c0: the weights prepared by
// ops/fused_egcl.prepare_weight, bf16 hi / lo pieces in the ring's slice
// layout; t_sp has 100 rows.
extern "C" int fused_egcl_launch(const int* idx, const float* edge_mask, const int* ebin,
                                 const float* egeo, const float* a, const float* B,
                                 const float* t_sp, const float* t_p, const float* w_r,
                                 const void* w_l1, const float* b_l1, const float* w_att,
                                 const float* b_att, const void* w_c0, const float* b_c0,
                                 const float* w_c1, float* agg, float* trans, int P, int N,
                                 int K, int channels, int coord, void* stream) {
  if (K < 1 || K > ROWS || channels != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FUSED_EGCL_ARGS                                                                  \
  idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1, w_att, b_att, w_c0, b_c0, \
      w_c1, agg, trans, P, N, K, s
  return coord ? launch<true>(FUSED_EGCL_ARGS) : launch<false>(FUSED_EGCL_ARGS);
#undef FUSED_EGCL_ARGS
}

// The single-pass bf16 mode.  B [P, N, C] bf16; tables [table_rows, C] bf16
// (T_sp's 100 rows, then T_p's); w_l1 / w_c0 prepared by
// ops/fused_egcl.prepare_weight_bf16 (W_l1 in the build's column order).
extern "C" int fused_egcl_bf16_launch(const int* idx, const float* edge_mask, const int* ebin,
                                      const float* egeo, const float* a, const void* B,
                                      const void* tables, const float* w_r, const void* w_l1,
                                      const float* b_l1, const float* w_att,
                                      const float* b_att, const void* w_c0, const float* b_c0,
                                      const float* w_c1, float* agg, float* trans, int P,
                                      int N, int K, int channels, int table_rows, int coord,
                                      void* stream) {
  if (K < 1 || K > ROWS || channels != C || table_rows != onepass::TABLE_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FUSED_EGCL_ARGS                                                                    \
  idx, edge_mask, ebin, egeo, a, B, tables, w_r, w_l1, b_l1, w_att, b_att, w_c0, b_c0, w_c1, \
      agg, trans, P, N, K, s
  return coord ? onepass::launch<true>(FUSED_EGCL_ARGS)
               : onepass::launch<false>(FUSED_EGCL_ARGS);
#undef FUSED_EGCL_ARGS
}
