// Fused Newton-Schulz preconditioner update for members too wide for one
// block of csrc/ns.cu (n > 160), hand-written for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by rmt_tpu_torch/ops/cuda_ns.py, whose
// plain-PyTorch twin computes the same function with torch.matmul.
//
// Replaces, for those widths, the TPU Pallas kernel
// rmt_tpu/ops/pallas_ns.py::ns_fused_step (_kernel), which takes a whole
// (1, n, n) member into VMEM at any n. Same step as csrc/ns.cu:
//
//   MPr   = Pr  - g*J Pr                                  (3 J-products)
//   MPc_r = Pcr - (mr*J Pcr - mi*J Pci)
//   MPc_i = Pci - (mr*J Pci + mi*J Pcr)
//   rho   = max(|I - MPr|_F, |I - MPc|_F) / sqrt(n)       of the INPUT
//   Pr'   = 2 Pr  - Pr MPr                                (5 products)
//   Pcr'  = 2 Pcr - (Pcr MPc_r - Pci MPc_i)
//   Pci'  = 2 Pci - (Pci MPc_r + Pcr MPc_i)
//
// What bounds it on an H100: operations. A member is 8 * 2 * n^3 float32
// operations (0.15 GFLOP at n = 210) against 7 n^2 floats moved, so the
// FFMA issue rate (67 TFLOP/s outside the tensor cores) is the limit, not
// the 3.35 TB/s of device memory. Float32 FFMA only: the Newton-Schulz
// certificate needs full float32 products (no TF32).
//
// Design: the update splits into independent column panels. For the
// columns jp of a panel, MP[:, jp] needs only P[:, jp], and P'[:, jp]
// needs only MP[:, jp]. A block owns one (member, panel) pair at a time
// and covers all n rows of the panel at once, one thread per 8 x 4
// micro-tile of each of three results (96 accumulators), so:
//
//   phase 1: k-slabs of J (all rows, 3 D columns) stream past the three P
//     panels held in shared memory; after a barrier each thread turns its
//     J P sums into MP entries in place of its P entries, and adds them
//     to its Frobenius sums;
//   phase 2: k-slabs of Pr, Pcr and Pci (all rows, D columns) stream past
//     the three MP panels; each thread writes 2P - P MP for its entries,
//     P read back from device memory (an L2 hit: its block staged it
//     just before).
//
// Nothing but the outputs and three partial sums a pair goes back to
// device memory. The geometry follows from n alone (cuda_ns.
// wide_geometry): all rows in one slab of 8-row micro-tiles, the fewest
// panels whose threads fit a block (at most 256), each as narrow as
// covers n, then the deepest k-slab D of 20, 12 or 4 whose shared memory
// fits (at most 227 KB). n = 210: 6 panels of 36 columns, 27 thread-rows
// covering 216 rows, 256 threads, slabs of 20; n = 420: 16 columns, 53
// thread-rows, slabs of 12; n = 1000: 8 columns, slabs of 4; the limit,
// n = 1584: 4 columns. Blocks stay resident (as many as the occupancy
// calculator allows) and walk the pairs in member order, panel fastest,
// so a member's panels run side by side and its J and P come from
// device memory about once a step, from L2 after that, at any member
// count.
//
// The copies into shared memory run one step ahead into the other slab
// buffer, issued right after the one barrier of a step. Thread t's rows
// are t / tx + r ty (r = 0..7), so a warp's threads read consecutive rows
// of a slab at once; a slab row holds its D floats, and D (like 3 D) is 4
// more than a multiple of 8, so 8 consecutive rows start in 8 different
// groups of 4 banks with no padding. Where n % 4 == 0 and the operands
// are 16-byte aligned, the slabs come through tensor maps (TMA): one
// thread a box of up to 256 rows, zeros outside the matrix, its bytes
// counted on the buffer's mbarrier. The SM's load units then issue no
// copy of a slab: at n = 420 (16-column panels) per-thread copies cost
// about a fifth of the time.
// Elsewhere every thread copies its share with cp.async, 8 bytes where n
// is even, 4 where n is odd or an operand is misaligned (n = 210's rows
// are 840 bytes, which neither a 16-byte copy nor a tensor map can
// follow). The P panels always come by cp.async, the next pair's during
// the epilogue; the next pair's first J slab during phase 2's last step.
// Phase 1 streams J alone, so its slabs are three times as deep
// (kJDepth) in the buffer that holds phase 2's three. Phase 1 reads a thread's A rows
// 4 k at a time (8 16-byte loads) and its 4 columns of each P panel per
// k (one 16-byte load): 20 loads for 384 FFMA; phase 2 reads A 2 k at a
// time: 30 loads for 320 FFMA. The k-loop of the last slab stops at n
// rounded up to 4 (the terms it skips are fma(0, 0, acc)).
//
// The Frobenius sums are kept per thread in micro-tile order, reduced by
// warp shuffles and then over the warps in order into (B, panels, 3)
// partial sums; a second kernel (one thread a member) adds the panels in
// order and forms rho: no float atomics, so repeats give the same bits.
// Entries outside the n x n matrix are staged as zeros and never stored.
// Outputs must not alias inputs: phase 2 reads Pr, Pcr, Pci while other
// blocks write the updated iterates.

#include <cuda.h>   // CUtensorMap and its encoder's types (no libcuda link)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRM = 8;              // rows of a thread's micro-tile
constexpr int kCM = 4;              // columns of a thread's micro-tile
constexpr int kMaxThreads = 256;    // 255 registers a thread
constexpr int kMaxSmem = 232448;    // a Hopper block's shared memory
constexpr int kHead = 128;          // bytes before the panels: two mbarriers
constexpr int kBoxRows = 256;       // most rows of a tensor-map box
// phase 1 streams J alone, so its slabs are kJDepth times deeper in the
// same buffer (which holds phase 2's three slabs)
constexpr int kJDepth = 3;

// The boxes a slab's rows are copied in by the tensor maps (at most 256
// rows each, a multiple of 8) and the rows a slab buffer holds.
__host__ __device__ inline int slab_boxes(int R) {
  return (R + kBoxRows - 1) / kBoxRows;
}
__host__ __device__ inline int box_rows(int R) {
  const int boxes = slab_boxes(R);
  return kRM * ((R / kRM + boxes - 1) / boxes);
}
// Floats of one matrix's A slab of depth D with R rows (its boxes' rows).
__host__ __device__ inline int slab_floats(int R, int D) {
  return slab_boxes(R) * box_rows(R) * D;
}
// Bytes of dynamic shared memory: the barriers, the three P / MP panels,
// two buffers of three A slabs (phase 1's single J slab, three times as
// deep, fills one of them), the per-warp sums.
inline long smem_need(int R, int W, int D, int threads) {
  return kHead + 4L * (3L * R * W + 6L * slab_floats(R, D)
                       + 3L * (threads / 32));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous copies into shared memory (cp.async): src_bytes = 0 fills
// the destination with zeros and reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  const unsigned d = smem_addr(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(in ? kBytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The tensor-map path (TMA): a box of a 3-d map (columns, rows, members)
// into shared memory, its bytes counted on an mbarrier.

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// Starts the barrier's next phase: one arrival, `bytes` to come.
__device__ __forceinline__ void bar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra.uni WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int col, int row, int member,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(member),
      "r"(smem_addr(bar))
      : "memory");
}

// X[i][j .. j+3] into dst[0 .. 3] in copies of cw bytes, zeros outside the
// n x n matrix (cw divides 4 n, so a copy is all in or all out).
__device__ __forceinline__ void copy4(float* dst, const float* __restrict__ X,
                                      int n, int i, int j, int cw) {
  const float* src = X + (size_t)i * n + j;
  if (cw == 16) {
    const bool in = i < n && j < n;
    cp_async<16>(dst, in ? src : X, in);
  } else if (cw == 8) {
#pragma unroll
    for (int u = 0; u < 4; u += 2) {
      const bool in = i < n && j + u < n;
      cp_async<8>(dst + u, in ? src + u : X, in);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = i < n && j + u < n;
      cp_async<4>(dst + u, in ? src + u : X, in);
    }
  }
}

// Columns [j0, j0 + W) of rows [0, R) of X into dst[k][c] (row stride W).
__device__ __forceinline__ void stage_panel(const float* __restrict__ X,
                                            float* dst, int n, int R, int W,
                                            int j0, int cw) {
  const int groups = W / 4;
  for (int e = threadIdx.x; e < R * groups; e += blockDim.x) {
    const int k = e / groups, c = 4 * (e % groups);
    copy4(dst + k * W + c, X, n, k, j0 + c, cw);
  }
}

// Rows [0, R) x columns [k0, k0 + D) of X into an A slab (D floats a
// row); D / 4 lanes copy a row, the thread's lane q, first row i0 and row
// step di precomputed (di = 0: the thread copies nothing).
__device__ __forceinline__ void stage_slab(const float* __restrict__ X,
                                           float* dst, int n, int R, int D,
                                           int k0, int q, int i0, int di,
                                           int cw) {
  if (di == 0) return;
  for (int i = i0; i < R; i += di)
    copy4(dst + i * D + q, X, n, i, k0 + q, cw);
}

// X[i][j .. j+3], zeros outside the n x n matrix, in loads of cw bytes.
__device__ __forceinline__ float4 ld4(const float* __restrict__ X, int n,
                                      int i, int j, int cw) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i >= n || j >= n) return v;
  const float* p = X + (size_t)i * n + j;
  if (cw == 16) return __ldg(reinterpret_cast<const float4*>(p));
  if (cw == 8) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v.x = a.x;
    v.y = a.y;
    if (j + 2 < n) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
      v.z = b.x;
      v.w = b.y;
    }
    return v;
  }
  v.x = __ldg(p);
  if (j + 1 < n) v.y = __ldg(p + 1);
  if (j + 2 < n) v.z = __ldg(p + 2);
  if (j + 3 < n) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ void st4(float* __restrict__ Y, int n, int i,
                                    int j, float4 v, int cw) {
  if (i >= n || j >= n) return;
  float* p = Y + (size_t)i * n + j;
  if (cw == 16) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (cw == 8) {
    *reinterpret_cast<float2*>(p) = make_float2(v.x, v.y);
    if (j + 2 < n) *reinterpret_cast<float2*>(p + 2) = make_float2(v.z, v.w);
    return;
  }
  p[0] = v.x;
  if (j + 1 < n) p[1] = v.y;
  if (j + 2 < n) p[2] = v.z;
  if (j + 3 < n) p[3] = v.w;
}

__device__ __forceinline__ void frag4(const float* src, float (&b)[kCM]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
}

// Y[i][j .. j+3] = 2 X[i][j .. j+3] - acc[r] for the 8 rows i = g + r ty
// of a micro-tile, X read from device memory.
__device__ __forceinline__ void store_update(const float* __restrict__ X,
                                             float* __restrict__ Y, int n,
                                             int g, int ty, int j,
                                             const float (&acc)[kRM][kCM],
                                             int cw) {
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const float4 x = ld4(X, n, g + r * ty, j, cw);
    st4(Y, n, g + r * ty, j,
        make_float4(2.0f * x.x - acc[r][0], 2.0f * x.y - acc[r][1],
                    2.0f * x.z - acc[r][2], 2.0f * x.w - acc[r][3]),
        cw);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    ns_wide_kernel(const float* __restrict__ Jg, const float* __restrict__ Prg,
                   const float* __restrict__ Pcrg,
                   const float* __restrict__ Pcig,
                   const float* __restrict__ hg, float* __restrict__ pr_out,
                   float* __restrict__ pcr_out, float* __restrict__ pci_out,
                   float* __restrict__ partial, int B, int n, int tx, int ty,
                   int D, int panels, int cw, int tma,
                   const __grid_constant__ CUtensorMap tm_j,
                   const __grid_constant__ CUtensorMap tm_pr,
                   const __grid_constant__ CUtensorMap tm_pcr,
                   const __grid_constant__ CUtensorMap tm_pci, float gamma,
                   float mu_r, float mu_i) {
  extern __shared__ __align__(128) float4 smem4[];
  const int W = kCM * tx;            // panel width
  const int R = kRM * ty;            // rows, n rounded up to 8
  const int mat = slab_floats(R, D);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);   // [2]
  float* Ps = reinterpret_cast<float*>(smem4) + kHead / 4;  // [3][R][W]
  float* As = Ps + 3 * R * W;                   // [2 buffers][3 matrices]
  float* red = As + 2 * 3 * mat;                // [3][warps]

  const int t = threadIdx.x;
  const int warps = blockDim.x / 32;
  const bool active = t < tx * ty;
  // a thread's rows are g, g + ty, ..., g + 7 ty: a warp's threads read 8
  // or more consecutive rows of an A slab at once, in distinct banks
  const int g0 = t / tx, col0 = kCM * (t % tx);
  const int DJ = kJDepth * D;                  // phase 1's slab depth
  const int rs = ty * D, rs_j = ty * DJ;      // its row step in a slab
  const int arow = g0 * D, arow_j = g0 * DJ;  // its first row
  const size_t nn = (size_t)n * n;
  const int slabs = (n + D - 1) / D;
  const int slabs_j = (n + DJ - 1) / DJ;
  const int pairs = B * panels;
  const float* const Pg[3] = {Prg, Pcrg, Pcig};
  float* const outg[3] = {pr_out, pcr_out, pci_out};
  // A-slab staging by cp.async: D / 4 lanes a row, blockDim.x / lanes
  // rows at a time (the threads past the last whole row copy nothing)
  const int lanes = D / 4, lanes_j = DJ / 4;
  const int rows_at = blockDim.x / lanes, rows_at_j = blockDim.x / lanes_j;
  const int sq = 4 * (t % lanes), si = t / lanes;
  const int sdi = si < rows_at ? rows_at : 0;
  const int sq_j = 4 * (t % lanes_j), si_j = t / lanes_j;
  const int sdi_j = si_j < rows_at_j ? rows_at_j : 0;

  const int boxes = slab_boxes(R), brows = box_rows(R);
  int buf = 0;           // the slab buffer of the current step
  unsigned parity = 0;   // bit b: the phase of slab buffer b's barrier

  // One step's slabs of member m from column k0 into slab buffer b: J's
  // (depth DJ) or the three P's (depth D). By cp.async, every thread its
  // share; or by the tensor maps, one thread a box, counted on buffer b's
  // barrier (armed before the barrier that precedes this).
  auto stage = [&](bool j_slab, int m, int k0, int b) {
    float* dst = As + b * 3 * mat;
    if (tma) {
      const int pitch = j_slab ? DJ : D;
      if (t < (j_slab ? 1 : 3) * boxes) {
        const int o = t / boxes, bx = t % boxes;
        const CUtensorMap* map = j_slab ? &tm_j
                                 : o == 0 ? &tm_pr
                                 : o == 1 ? &tm_pcr : &tm_pci;
        tma_load(dst + o * mat + bx * brows * pitch, map, k0, bx * brows, m,
                 &bars[b]);
      }
    } else if (j_slab) {
      stage_slab(Jg + m * nn, dst, n, R, DJ, k0, sq_j, si_j, sdi_j, cw);
    } else {
#pragma unroll
      for (int o = 0; o < 3; ++o)
        stage_slab(Pg[o] + m * nn, dst + o * mat, n, R, D, k0, sq, si, sdi,
                   cw);
    }
    cp_async_commit();
  };
  // The start of a step: its slabs have landed (and the panels' copies),
  // the barrier of the buffer the next step's slabs go to is armed, and
  // every warp is done with the step before.
  auto begin = [&](bool next, bool next_j) {
    cp_async_wait_all();
    if (tma) {
      bar_wait(&bars[buf], (parity >> buf) & 1u);
      parity ^= 1u << buf;
      if (next && t == 0)
        bar_arm(&bars[buf ^ 1], 4u * 3 * mat);   // one J slab or three
    }
    __syncthreads();
  };

  // A block stays resident and takes pairs q = blockIdx.x, + gridDim.x,
  // ...: member q / panels, panel q % panels. The copies run one step
  // ahead of the arithmetic: after the barrier that starts a step (every
  // warp is done with the step before), the next step's slabs go into the
  // other slab buffer.
  int q = blockIdx.x;
  if (q >= pairs) return;
  if (tma && t == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const int m = q / panels, j0 = (q % panels) * W;
#pragma unroll
    for (int o = 0; o < 3; ++o)
      stage_panel(Pg[o] + m * nn, Ps + o * R * W, n, R, W, j0, cw);
    if (tma && t == 0) bar_arm(&bars[0], 4u * 3 * mat);
    __syncthreads();
    stage(true, m, 0, 0);
  }

  for (; q < pairs; q += gridDim.x) {
    const int m = q / panels, j0 = (q % panels) * W;
    const int qn = q + gridDim.x;
    const bool has_next = qn < pairs;
    const int mx = has_next ? qn / panels : 0;
    const int jx = has_next ? (qn % panels) * W : 0;
    const float* P[3] = {Prg + m * nn, Pcrg + m * nn, Pcig + m * nn};
    const float h = hg[m];
    const float g = gamma * h;
    const float mr = mu_r * h;
    const float mi = mu_i * h;

    // ---- phase 1: J [Pr | Pcr | Pci] on the panel -----------------------
    float acc[3][kRM][kCM];
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < kCM; ++c) acc[o][r][c] = 0.0f;

    for (int s = 0; s < slabs_j; ++s) {
      const bool last = s + 1 == slabs_j;
      begin(true, !last);
      if (!last)
        stage(true, m, (s + 1) * DJ, buf ^ 1);
      else   // phase 2's first slabs
        stage(false, m, 0, buf ^ 1);
      const float* A = As + buf * 3 * mat + arow_j;
      const float* Bk = Ps + s * DJ * W + col0;
      // past n the slab holds zeros: fma(0, 0, acc) is acc, so stop at
      // n rounded up to 4
      const int kend = min(DJ, (n - s * DJ + 3) & ~3);
      if (active) {
#pragma unroll 2
        for (int k = 0; k < kend; k += 4) {
          float a[kRM][4];
#pragma unroll
          for (int r = 0; r < kRM; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(A + r * rs_j + k);
            a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float bv[3][kCM];
#pragma unroll
            for (int o = 0; o < 3; ++o)
              frag4(Bk + o * R * W + (k + kk) * W, bv[o]);
#pragma unroll
            for (int o = 0; o < 3; ++o)
#pragma unroll
              for (int r = 0; r < kRM; ++r)
#pragma unroll
                for (int c = 0; c < kCM; ++c)
                  acc[o][r][c] = fmaf(a[r][kk], bv[o][c], acc[o][r][c]);
          }
        }
      }
      buf ^= 1;
    }
    // every warp is done reading the P panels: each thread replaces its
    // own P entries by its MP entries (phase 2's first barrier orders
    // these writes before any read of them)
    __syncthreads();
    float s_r = 0.0f, s_c = 0.0f, s_i = 0.0f;
    if (active) {
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int i = g0 + r * ty;
        float* at = Ps + i * W + col0;
        float pr[kCM], pcr[kCM], pci[kCM];
        frag4(at, pr);
        frag4(at + R * W, pcr);
        frag4(at + 2 * R * W, pci);
#pragma unroll
        for (int c = 0; c < kCM; ++c) {
          const int j = j0 + col0 + c;
          const float jp = acc[0][r][c];
          const float jpr = acc[1][r][c];
          const float jpi = acc[2][r][c];
          float mpr = pr[c] - g * jp;
          float mpcr = pcr[c] - (mr * jpr - mi * jpi);
          float mpci = pci[c] - (mr * jpi + mi * jpr);
          if (i < n && j < n) {
            const float e = (i == j) ? 1.0f : 0.0f;
            const float dr = e - mpr;
            const float dc = e - mpcr;
            s_r += dr * dr;
            s_c += dc * dc;
            s_i += mpci * mpci;
          } else {
            mpr = mpcr = mpci = 0.0f;
          }
          pr[c] = mpr;
          pcr[c] = mpcr;
          pci[c] = mpci;
        }
        *reinterpret_cast<float4*>(at) = make_float4(pr[0], pr[1], pr[2],
                                                     pr[3]);
        *reinterpret_cast<float4*>(at + R * W) =
            make_float4(pcr[0], pcr[1], pcr[2], pcr[3]);
        *reinterpret_cast<float4*>(at + 2 * R * W) =
            make_float4(pci[0], pci[1], pci[2], pci[3]);
      }
    }

    // ---- phase 2: P (M P) on the panel, real and complex ----------------
    float ar[kRM][kCM], acr[kRM][kCM], aci[kRM][kCM];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < kCM; ++c) {
        ar[r][c] = 0.0f;
        acr[r][c] = 0.0f;
        aci[r][c] = 0.0f;
      }

    for (int s = 0; s < slabs; ++s) {
      const bool last = s + 1 == slabs;
      begin(!last || has_next, last);
      if (!last)
        stage(false, m, (s + 1) * D, buf ^ 1);
      else if (has_next)   // the next pair's first J slab
        stage(true, mx, 0, buf ^ 1);
      const float* A = As + buf * 3 * mat + arow;
      const float* Bk = Ps + s * D * W + col0;
      const int kend = min(D, (n - s * D + 3) & ~3);
      if (active) {
#pragma unroll 2
        for (int k = 0; k < kend; k += 2) {
          float a[3][kRM][2];
#pragma unroll
          for (int o = 0; o < 3; ++o)
#pragma unroll
            for (int r = 0; r < kRM; ++r) {
              const float2 v = *reinterpret_cast<const float2*>(
                  A + o * mat + r * rs + k);
              a[o][r][0] = v.x;
              a[o][r][1] = v.y;
            }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            float bv[3][kCM];
#pragma unroll
            for (int o = 0; o < 3; ++o)
              frag4(Bk + o * R * W + (k + kk) * W, bv[o]);
#pragma unroll
            for (int r = 0; r < kRM; ++r)
#pragma unroll
              for (int c = 0; c < kCM; ++c) {
                ar[r][c] = fmaf(a[0][r][kk], bv[0][c], ar[r][c]);
                // (Pcr + i Pci)(MPc_r + i MPc_i)
                acr[r][c] = fmaf(a[1][r][kk], bv[1][c], acr[r][c]);
                acr[r][c] = fmaf(-a[2][r][kk], bv[2][c], acr[r][c]);
                aci[r][c] = fmaf(a[2][r][kk], bv[1][c], aci[r][c]);
                aci[r][c] = fmaf(a[1][r][kk], bv[2][c], aci[r][c]);
              }
          }
        }
      }
      buf ^= 1;
    }
    // every warp is done reading the MP panels: the next pair's P panels
    // load while the epilogue stores
    __syncthreads();
    if (has_next) {
#pragma unroll
      for (int o = 0; o < 3; ++o)
        stage_panel(Pg[o] + mx * nn, Ps + o * R * W, n, R, W, jx, cw);
      cp_async_commit();
    }
    if (active) {   // 2P - P MP
      const int j = j0 + col0;
      store_update(P[0], outg[0] + m * nn, n, g0, ty, j, ar, cw);
      store_update(P[1], outg[1] + m * nn, n, g0, ty, j, acr, cw);
      store_update(P[2], outg[2] + m * nn, n, g0, ty, j, aci, cw);
    }

    // the pair's Frobenius sums, in a fixed order: a shuffle tree in each
    // warp, then the warps in turn
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s_r += __shfl_down_sync(0xffffffffu, s_r, off);
      s_c += __shfl_down_sync(0xffffffffu, s_c, off);
      s_i += __shfl_down_sync(0xffffffffu, s_i, off);
    }
    if ((t & 31) == 0) {
      red[t / 32] = s_r;
      red[warps + t / 32] = s_c;
      red[2 * warps + t / 32] = s_i;
    }
    __syncthreads();
    if (t < 3) {
      float s = 0.0f;
      for (int w = 0; w < warps; ++w) s += red[t * warps + w];
      partial[(size_t)q * 3 + t] = s;
    }
  }
}

// rho of each member from its panels' partial sums, added in panel order.
__global__ void ns_wide_rho_kernel(const float* __restrict__ partial,
                                   float* __restrict__ rho_out, int B, int n,
                                   int panels) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  float s_r = 0.0f, s_c = 0.0f, s_i = 0.0f;
  for (int p = 0; p < panels; ++p) {
    const float* q = partial + ((size_t)m * panels + p) * 3;
    s_r += q[0];
    s_c += q[1];
    s_i += q[2];
  }
  const float inv_n = 1.0f / (float)n;
  const float res_r = sqrtf(s_r * inv_n);
  const float res_c = sqrtf((s_c + s_i) * inv_n);
  // a NaN on either side must reach the certificate (fmaxf drops it)
  rho_out[m] = (res_r > res_c || res_r != res_r) ? res_r : res_c;
}

cudaError_t set_smem_attribute() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ns_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The map of the (B, n, n) float32 tensor X in boxes of `cols` columns x
// `rows` rows of one member, zeros outside it (libcuda's encoder,
// reached through the runtime).
cudaError_t encode_map(CUtensorMap* map, const float* X, int B, int n,
                       int cols, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 4, (cuuint64_t)n * n * 4};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(X), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches both kernels on the caller's stream and returns a cudaError_t
// (0 on success); nothing synchronises. J, Pr, Pcr, Pci, the three
// outputs: (B, n, n) float32; h, rho: (B,); partial: (B, panels, 3)
// scratch. tx, ty, depth, panels, threads, smem_bytes: the geometry of
// cuda_ns.wide_geometry(n); copy_bytes: 16, 8 or 4, dividing 4 n and the
// address of every matrix. With 16-byte copies the slabs come through
// tensor maps (TMA), else through cp.async.
int ns_wide_step_launch(const float* J, const float* Pr, const float* Pcr,
                        const float* Pci, const float* h, float* pr_out,
                        float* pcr_out, float* pci_out, float* rho,
                        float* partial, int B, int n, int tx, int ty,
                        int depth, int panels, int threads, int smem_bytes,
                        int copy_bytes, float gamma, float mu_r, float mu_i,
                        void* stream) {
  const int R = kRM * ty, W = kCM * tx, cw = copy_bytes;
  bool ok = B > 0 && n > 0 && tx > 0 && ty > 0 && R >= n
            && (depth == 4 || depth == 12 || depth == 20)
            && panels * W >= n && (panels - 1) * W < n
            && (long)B * panels <= 0x7fffffffL && threads >= tx * ty
            && threads <= kMaxThreads && threads % 32 == 0
            && smem_bytes <= kMaxSmem
            && smem_bytes >= smem_need(R, W, depth, threads)
            && (cw == 4 || cw == 8 || cw == 16) && (4 * n) % cw == 0;
  const void* mats[7] = {J, Pr, Pcr, Pci, pr_out, pcr_out, pci_out};
  for (const void* p : mats) ok = ok && (size_t)p % cw == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  const int tma = cw == 16;
  CUtensorMap maps[4] = {};
  if (tma) {
    const float* src[4] = {J, Pr, Pcr, Pci};
    for (int o = 0; o < 4 && err == cudaSuccess; ++o)
      err = encode_map(&maps[o], src[o], B, n,
                       o == 0 ? kJDepth * depth : depth, box_rows(R));
    if (err != cudaSuccess) return (int)err;
  }
  // resident blocks, as many as fit, each walking its pairs
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ns_wide_kernel, threads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int pairs = B * panels;
  const int grid = pairs < sms * per_sm ? pairs : sms * per_sm;
  const cudaStream_t s = (cudaStream_t)stream;
  ns_wide_kernel<<<grid, threads, smem_bytes, s>>>(
      J, Pr, Pcr, Pci, h, pr_out, pcr_out, pci_out, partial, B, n, tx, ty,
      depth, panels, cw, tma, maps[0], maps[1], maps[2], maps[3], gamma,
      mu_r, mu_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ns_wide_rho_kernel<<<(B + 127) / 128, 128, 0, s>>>(partial, rho, B, n,
                                                     panels);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at this geometry (cudaOccupancy...), or -1.
int ns_wide_blocks_per_sm(int threads, int smem_bytes) {
  if (set_smem_attribute() != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ns_wide_kernel, threads, smem_bytes) != cudaSuccess)
    return -1;
  return blocks;
}

}  // extern "C"
