// Exact block-bidiagonal Radau stage solves for the lockstep ensemble,
// hand-written for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by rmt_tpu_torch/ops/cuda_block.py, whose plain-PyTorch twins compute
// the same functions in the same order.
//
// Layouts are member-last, exactly as on the TPU: matrices (z, m, m, B),
// stage vectors (3, m, z, B), vectors (m, z, B). The member index is the
// fastest-moving axis, so a warp whose lanes are neighbouring members
// reads and writes whole 128-byte lines. Built with -fmad=false so each
// product and sum rounds like the twin's, and every kernel equals its
// twin bit for bit. Sizes below are at the main path's B = 4096, z = 20,
// m = 7 on an H100 (3.35 TB/s, 132 SMs).
//
// block_factor <- rmt_tpu/ops/pallas_block.py block_factor (_factor_kernel,
//   _gj_inverse, _matmat). Per member and node, three 7x7 Gauss-Jordan
//   inversions (I - h*gamma*Jd, Am = I - h*mu_r*Jd, and S = Am + Bm Am^-1
//   Bm with Bm = -h*mu_i*Jd) and three products. Bound by bytes: Jd in,
//   three inverses out, 64 MB (19 us); its arithmetic, about 0.35 GFLOP,
//   is 5 us of the float32 rate. What bounds it in practice is issue:
//   about 8,000 instructions a thread (147 IEEE divisions, the row swaps'
//   selects), 23 us at four a cycle on every SM. The augmented [A | I]
//   form spent half its work on the identity half and its ~200 live
//   floats (231 registers) allowed 8 warps an SM in 2.4 waves. So: one
//   thread per (member, node), Gauss-Jordan in place (each pivot column's
//   slot receives the inverse's column, the row swaps are undone as
//   column swaps at the end; the same operations in the same order as the
//   twin's augmented form, so the same numbers), Jd reloaded from cache
//   for each use instead of kept live, the products as loops over one
//   column or row at a time, and XB = Am^-1 Bm parked in shared memory
//   across the last inversion. At m = 7: 96 registers (a 40-byte spill),
//   25,088 bytes of shared memory; kFactorBlocksPerSM blocks of
//   kFactorThreads an SM, 20 warps, hold the 640 blocks of the main path
//   in one wave (cuda_block.factor_geometry). The swaps are picks (one
//   PTX slct each): with plain selects the compiler indexed W dynamically
//   and kept it in local memory, which cost more than the redesign saved.
//
// block_apply <- pallas_block.block_apply (_apply_kernel, _matvec). W =
//   T^-1 R, the real and complex recurrences over the z nodes and dK =
//   Re(T Z). Bound by bytes: every Minv and Jl block once, 78 MB (23 us);
//   the arithmetic is a recurrence over the nodes, so it reaches that only
//   with enough bytes in flight. A block takes a tile of kTileMembers
//   members with m warps' worth of threads (tile_geometry): thread (lane,
//   i) owns row i of every block and variable i of every vector of member
//   b0 + lane, fetches its row of kAhead nodes ahead into registers while
//   a node computes (load_node), and the recurrence vectors pass between
//   rows through shared memory, the real and the complex recurrence in
//   the same two phases (two barriers a node). 128 blocks at B = 4096.
//
// block_apply_real <- pallas_block.block_apply_real (_real_kernel). The
//   real-shift recurrence x_z = Minv_z (e_z + h*gamma*Jl_z x_{z-1}) that
//   smooths the error estimate. Bound by bytes: Minv_r and Jl once, 37 MB
//   (11 us; it fits the 50 MB L2, so back-to-back calls may beat that).
//   One thread per member left 100 of 132 SMs idle and exposed each
//   node's two dependent matvecs. It now runs block_apply's design on its
//   one recurrence: a tile of kTileMembers members, thread (lane, i) with
//   row i of Jl_z and Minv_z and variable i of e_z (2m + 1 loads a node,
//   kAhead nodes ahead), phase 1 t = e + g Jl x into shared memory, phase
//   2 x = Minv t (tile_geometry). At m = 7: 67 registers, no spills,
//   1,792 bytes of shared memory.
//
// Every dot product keeps the twin's j order (acc = a0 x0; acc = acc +
// aj xj). Partial pivoting takes the FIRST maximum (ties go to the lowest
// row), as the TPU kernel does. A ragged tile repeats its last member and
// stores only the live ones.

#include <cuda_runtime.h>

namespace {

// block_factor: threads a block (one per member and node), and the blocks
// an SM must hold (__launch_bounds__; cuda_block.factor_geometry)
constexpr int kFactorThreads = 128;
constexpr int kFactorBlocksPerSM = 5;
// members a block of the recurrence kernels, block_apply and
// block_apply_real: a warp's lanes, so a warp's load of one matrix entry
// is one 128-byte line (cuda_block.tile_geometry)
constexpr int kTileMembers = 32;
// nodes of the recurrence kernels whose loads are in flight while one
// computes (block_apply_real timed the same with 2, 3, 4 and 6)
constexpr int kAhead = 2;

// p itself, opaque to the compiler: loads through it are issued again
// (cache hits) rather than served from registers kept live since an
// earlier load of the same address
__device__ __forceinline__ const float* reload(const float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// c ? a : b as one PTX slct, opaque to the compiler: a chain of plain
// selects over the rows of a register array is folded into a load at a
// dynamic index, which moves the whole array to local memory
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float d;
  asm("slct.f32.s32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b),
      "r"(c ? 0 : -1));
  return d;
}

// W = I - s * J, J's entry (i, j) at J[(i * M + j) * sB]
template <int M>
__device__ __forceinline__ void set_shifted(float (&W)[M][M],
                                            const float* J, int sB,
                                            float s) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
      W[i][j] = (i == j ? 1.0f : 0.0f) - s * __ldg(J + (i * M + j) * sB);
}

template <int M>
__device__ __forceinline__ void store_block(float* out, int sB,
                                            const float (&W)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) out[(i * M + j) * sB] = W[i][j];
}

// W^-1 in place by Gauss-Jordan with partial pivoting. The twin works on
// [W | I]; here column col's slot takes, once col is eliminated, the
// column of the right half that col's step turns from a unit vector into
// a live one, so each live entry sees the twin's operations in the
// twin's order (where the twin subtracts from a zero of the identity
// half, 0.0f - f * q; its pivot entry 1 / pv). The right half's columns
// then stand permuted by the row swaps: undone at the end as column
// swaps, last step first. Swaps are picks over the unrolled indices,
// never a dynamic index into a register array.
template <int M>
__device__ __forceinline__ void gj_inverse(float (&W)[M][M]) {
  int piv[M];
#pragma unroll
  for (int col = 0; col < M; ++col) {
    float best = fabsf(W[col][col]);
    int p = col;
#pragma unroll
    for (int r = col + 1; r < M; ++r) {
      const float mg = fabsf(W[r][col]);
      if (mg > best) {
        best = mg;
        p = r;
      }
    }
    piv[col] = p;
    float q[M];  // the pivot row
#pragma unroll
    for (int j = 0; j < M; ++j) q[j] = W[col][j];
#pragma unroll
    for (int r = col + 1; r < M; ++r) {
      const bool sw = p == r;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float a = W[r][j];
        q[j] = pick(sw, a, q[j]);
        W[r][j] = pick(sw, W[col][j], a);
      }
    }
    const float pv = q[col];
#pragma unroll
    for (int j = 0; j < M; ++j) q[j] = (j == col ? 1.0f : q[j]) / pv;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (r == col) continue;
      const float f = W[r][col];
#pragma unroll
      for (int j = 0; j < M; ++j)
        W[r][j] = (j == col ? 0.0f : W[r][j]) - f * q[j];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) W[col][j] = q[j];
  }
#pragma unroll
  for (int col = M - 2; col >= 0; --col) {
#pragma unroll
    for (int c = col + 1; c < M; ++c) {
      const bool sw = piv[col] == c;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float a = W[r][col];
        W[r][col] = pick(sw, W[r][c], a);
        W[r][c] = pick(sw, a, W[r][c]);
      }
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kFactorThreads, kFactorBlocksPerSM)
    factor_kernel(const float* __restrict__ jd, const float* __restrict__ h,
                  float* __restrict__ minv_r, float* __restrict__ minv_cr,
                  float* __restrict__ minv_ci, int B, int Z, float gamma,
                  float mu_r, float mu_i) {
  // XB of this thread, entry (i, k) at s_xb[i * M + k][tid]: neighbouring
  // threads on neighbouring banks
  __shared__ float s_xb[M * M][kFactorThreads];
  const int tid = threadIdx.x;
  const long idx = (long)blockIdx.x * kFactorThreads + tid;
  if (idx >= (long)B * Z) return;
  const int b = (int)(idx % B);
  const int z = (int)(idx / B);
  const int sB = B;  // entry (i, j) of a block at (i * M + j) * sB
  const long base = (long)z * M * M * B + b;
  const float* J = jd + base;
  const float hb = h[b];
  const float g = gamma * hb;
  const float mr = mu_r * hb;
  const float mi = mu_i * hb;
  const float nmi = 0.0f - mi;
  float W[M][M];

  // real shift: (I - h*gamma*Jd)^-1
  set_shifted<M>(W, J, sB, g);
  gj_inverse<M>(W);
  store_block<M>(minv_r + base, sB, W);

  // complex shift (Am + i Bm)^-1 with Am = I - h*mu_r*Jd, Bm = -h*mu_i*Jd,
  // from two real inversions: Y = (Am + Bm Am^-1 Bm)^-1 and
  // (Am + i Bm)^-1 = Y - i Am^-1 Bm Y. The products run as loops over
  // one column or row at a time, so only its operands are live beside W.
  set_shifted<M>(W, reload(J), sB, mr);
  gj_inverse<M>(W);  // X = Am^-1
  // XB = X Bm, a column of Bm at a time
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    float bk[M];
#pragma unroll
    for (int j = 0; j < M; ++j) bk[j] = nmi * __ldg(J + (j * M + k) * sB);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float acc = W[i][0] * bk[0];
#pragma unroll
      for (int j = 1; j < M; ++j) acc = acc + W[i][j] * bk[j];
      s_xb[i * M + k][tid] = acc;
    }
  }
  // S = Am + Bm XB in W: the sum over j outermost (each entry's terms in
  // the twin's order), a column j of Bm and a row j of XB at a time
  auto term = [&](int j, float (&bj)[M], float (&xj)[M]) {
    const float* Jj = reload(J) + j * sB;
#pragma unroll
    for (int i = 0; i < M; ++i) bj[i] = nmi * __ldg(Jj + i * M * sB);
#pragma unroll
    for (int k = 0; k < M; ++k) xj[k] = s_xb[j * M + k][tid];
  };
  {
    float bj[M], xj[M];
    term(0, bj, xj);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int k = 0; k < M; ++k) W[i][k] = bj[i] * xj[k];
  }
#pragma unroll 1
  for (int j = 1; j < M; ++j) {
    float bj[M], xj[M];
    term(j, bj, xj);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int k = 0; k < M; ++k) W[i][k] = W[i][k] + bj[i] * xj[k];
  }
  const float* Jr = reload(J);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k)
      W[i][k] = ((i == k ? 1.0f : 0.0f) - mr * __ldg(Jr + (i * M + k) * sB)) +
                W[i][k];
  gj_inverse<M>(W);  // Y
  store_block<M>(minv_cr + base, sB, W);
  // -XB Y, a row of XB at a time
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float xi[M];
#pragma unroll
    for (int j = 0; j < M; ++j) xi[j] = s_xb[i * M + j][tid];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float acc = xi[0] * W[0][k];
#pragma unroll
      for (int j = 1; j < M; ++j) acc = acc + xi[j] * W[j][k];
      minv_ci[base + (i * M + k) * sB] = -acc;
    }
  }
}

struct ApplyCoef {
  float w0[3], w1r[3], w1i[3];  // rows of T^-1 (real row 0, complex row 1)
  float c0[3], c1[3], c2[3];    // dK_i = c0 z0 + c1 Re z1 - c2 Im z1
  float gamma, mu_r, mu_i;
};

// node z's operands of thread (lane, i) in block_apply and
// block_apply_real: row i of K m x m blocks and variable i of S stage
// vectors
template <int M, int K, int S>
struct NodeRow {
  float a[K][M], v[S];
};

// mats: K (z, m, m, B) blocks; vec: S (m, z, B) vectors one after the
// other; row: entry (i, 0) of node 0's block of the thread's member;
// rvec: variable i of vector 0 at node 0
template <int M, int K, int S>
__device__ __forceinline__ void load_node(NodeRow<M, K, S>& o,
                                          const float* const (&mats)[K],
                                          const float* vec, long row,
                                          long rvec, long sB, int z, int Z) {
  const long at = z * (long)M * M * sB + row;
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) o.a[k][j] = __ldg(mats[k] + at + j * sB);
#pragma unroll
  for (int s = 0; s < S; ++s)
    o.v[s] = __ldg(vec + rvec + ((long)s * M * Z + z) * sB);
}

// a pipe of N nodes of one thread: node[0] computes while the loads of
// node[1 .. N - 1] are in flight. start_nodes fetches nodes 0 .. N - 2;
// each step fetches node z + N - 1 into node[N - 1] before node z
// computes, then shift_nodes moves the pipe on by one
template <int M, int K, int S, int N>
__device__ __forceinline__ void start_nodes(NodeRow<M, K, S> (&node)[N],
                                            const float* const (&mats)[K],
                                            const float* vec, long row,
                                            long rvec, long sB, int Z) {
#pragma unroll
  for (int a = 0; a + 1 < N; ++a)
    if (a < Z) load_node<M>(node[a], mats, vec, row, rvec, sB, a, Z);
}

template <class T, int N>
__device__ __forceinline__ void shift_nodes(T (&node)[N]) {
#pragma unroll
  for (int a = 0; a + 1 < N; ++a) node[a] = node[a + 1];
}

// row . x in the twin's order: acc = a[0] x[0]; acc = acc + a[j] x[j]
template <int M, int TB>
__device__ __forceinline__ float rowdot(const float (&a)[M],
                                        const float (*x)[TB], int lane) {
  float acc = a[0] * x[0][lane];
#pragma unroll
  for (int j = 1; j < M; ++j) acc = acc + a[j] * x[j][lane];
  return acc;
}

template <int M>
__global__ void __launch_bounds__(M * kTileMembers)
    apply_kernel(const float* __restrict__ r, const float* __restrict__ minv_r,
                 const float* __restrict__ minv_cr,
                 const float* __restrict__ minv_ci,
                 const float* __restrict__ jl, const float* __restrict__ h,
                 float* __restrict__ dk, int B, int Z, ApplyCoef c) {
  constexpr int TB = kTileMembers;
  // x_{z-1} of the three recurrences, then x_z; the right-hand sides
  __shared__ float s_x0[M][TB], s_x1r[M][TB], s_x1i[M][TB];
  __shared__ float s_t[M][TB], s_rr[M][TB], s_ri[M][TB];
  const int lane = threadIdx.x, i = threadIdx.y;
  const int bm = blockIdx.x * TB + lane;
  const bool live = bm < B;
  const int b = live ? bm : B - 1;  // a ragged tile repeats its last member
  const float hb = h[b];
  const float g = c.gamma * hb;
  const float mr = c.mu_r * hb;
  const float mi = c.mu_i * hb;
  const long sB = B;
  const long row = (long)i * M * sB + b;   // entry (i, 0) of node 0's block
  const long rvec = (long)i * Z * sB + b;  // stage 0, variable i, node 0
  // the blocks of a node: Jl, Minv_r, Minv_cr, Minv_ci
  const float* const mats[4] = {jl, minv_r, minv_cr, minv_ci};

  constexpr int A = kAhead;
  NodeRow<M, 4, 3> node[A + 1];
  start_nodes<M>(node, mats, r, row, rvec, sB, Z);
  s_x0[i][lane] = s_x1r[i][lane] = s_x1i[i][lane] = 0.0f;
  __syncthreads();
  for (int z = 0; z < Z; ++z) {
    if (z + A < Z) load_node<M>(node[A], mats, r, row, rvec, sB, z + A, Z);
    const NodeRow<M, 4, 3>& cur = node[0];
    const float r0 = cur.v[0], r1 = cur.v[1], r2 = cur.v[2];
    const float w0 = (c.w0[0] * r0 + c.w0[1] * r1) + c.w0[2] * r2;
    const float w1r = (c.w1r[0] * r0 + c.w1r[1] * r1) + c.w1r[2] * r2;
    const float w1i = (c.w1i[0] * r0 + c.w1i[1] * r1) + c.w1i[2] * r2;
    // phase 1: h*mu*Jl_z x_{z-1} for the real and the complex recurrence
    const float t = rowdot<M>(cur.a[0], s_x0, lane);
    const float ur = rowdot<M>(cur.a[0], s_x1r, lane);
    const float ui = rowdot<M>(cur.a[0], s_x1i, lane);
    s_t[i][lane] = w0 + g * t;
    s_rr[i][lane] = (w1r + mr * ur) - mi * ui;
    s_ri[i][lane] = (w1i + mr * ui) + mi * ur;
    __syncthreads();
    // phase 2: x_z = Minv_z (...), real and (Mc_r + i Mc_i) complex
    const float x0 = rowdot<M>(cur.a[1], s_t, lane);
    const float x1r = rowdot<M>(cur.a[2], s_rr, lane) -
                      rowdot<M>(cur.a[3], s_ri, lane);
    const float x1i = rowdot<M>(cur.a[2], s_ri, lane) +
                      rowdot<M>(cur.a[3], s_rr, lane);
    s_x0[i][lane] = x0;
    s_x1r[i][lane] = x1r;
    s_x1i[i][lane] = x1i;
    // dK = Re(T Z), Z = [z0, z1, conj(z1)]: row i needs its own x alone
    if (live) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
        dk[rvec + ((long)s * M * Z + z) * sB] =
            (c.c0[s] * x0 + c.c1[s] * x1r) - c.c2[s] * x1i;
    }
    shift_nodes(node);
    __syncthreads();
  }
}

template <int M>
__global__ void __launch_bounds__(M * kTileMembers)
    real_kernel(const float* __restrict__ e, const float* __restrict__ minv_r,
                const float* __restrict__ jl, const float* __restrict__ h,
                float* __restrict__ x, int B, int Z, float gamma) {
  constexpr int TB = kTileMembers;
  __shared__ float s_x[M][TB], s_t[M][TB];  // x_{z-1}, then x_z; the rhs
  const int lane = threadIdx.x, i = threadIdx.y;
  const int bm = blockIdx.x * TB + lane;
  const bool live = bm < B;
  const int b = live ? bm : B - 1;  // a ragged tile repeats its last member
  const float g = gamma * h[b];
  const long sB = B;
  const long row = (long)i * M * sB + b;   // entry (i, 0) of node 0's block
  const long rvec = (long)i * Z * sB + b;  // variable i, node 0
  const float* const mats[2] = {jl, minv_r};

  constexpr int A = kAhead;
  NodeRow<M, 2, 1> node[A + 1];
  start_nodes<M>(node, mats, e, row, rvec, sB, Z);
  s_x[i][lane] = 0.0f;
  __syncthreads();
  for (int z = 0; z < Z; ++z) {
    if (z + A < Z) load_node<M>(node[A], mats, e, row, rvec, sB, z + A, Z);
    const NodeRow<M, 2, 1>& cur = node[0];
    // phase 1: e_z + h*gamma*Jl_z x_{z-1}
    s_t[i][lane] = cur.v[0] + g * rowdot<M>(cur.a[0], s_x, lane);
    __syncthreads();
    // phase 2: x_z = Minv_z (...)
    const float xi = rowdot<M>(cur.a[1], s_t, lane);
    s_x[i][lane] = xi;
    if (live) x[rvec + (long)z * sB] = xi;
    shift_nodes(node);
    __syncthreads();
  }
}

#define RMT_DISPATCH_M(m, CALL) \
  switch (m) {                  \
    case 2: CALL(2); break;     \
    case 3: CALL(3); break;     \
    case 4: CALL(4); break;     \
    case 5: CALL(5); break;     \
    case 6: CALL(6); break;     \
    case 7: CALL(7); break;     \
    case 8: CALL(8); break;     \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); nothing synchronises.

int block_factor_launch(const float* jd, const float* h, float* minv_r,
                        float* minv_cr, float* minv_ci, int B, int Z, int m,
                        float gamma, float mu_r, float mu_i, void* stream) {
  const long n = (long)B * Z;
  const int grid = (int)((n + kFactorThreads - 1) / kFactorThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define RMT_LAUNCH(MM)                                                   \
  factor_kernel<MM><<<grid, kFactorThreads, 0, s>>>(                     \
      jd, h, minv_r, minv_cr, minv_ci, B, Z, gamma, mu_r, mu_i)
  RMT_DISPATCH_M(m, RMT_LAUNCH)
#undef RMT_LAUNCH
  return (int)cudaGetLastError();
}

// coef (host memory): w0[3], w1r[3], w1i[3], c0[3], c1[3], c2[3], gamma,
// mu_r, mu_i -- 21 floats, copied into the kernel's parameter block
int block_apply_launch(const float* r, const float* minv_r,
                       const float* minv_cr, const float* minv_ci,
                       const float* jl, const float* h, float* dk, int B,
                       int Z, int m, const float* coef, void* stream) {
  ApplyCoef c;
  for (int i = 0; i < 3; ++i) {
    c.w0[i] = coef[i];
    c.w1r[i] = coef[3 + i];
    c.w1i[i] = coef[6 + i];
    c.c0[i] = coef[9 + i];
    c.c1[i] = coef[12 + i];
    c.c2[i] = coef[15 + i];
  }
  c.gamma = coef[18];
  c.mu_r = coef[19];
  c.mu_i = coef[20];
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (B + kTileMembers - 1) / kTileMembers;
#define RMT_LAUNCH(MM)                                                  \
  apply_kernel<MM><<<grid, dim3(kTileMembers, MM), 0, s>>>(             \
      r, minv_r, minv_cr, minv_ci, jl, h, dk, B, Z, c)
  RMT_DISPATCH_M(m, RMT_LAUNCH)
#undef RMT_LAUNCH
  return (int)cudaGetLastError();
}

int block_apply_real_launch(const float* e, const float* minv_r,
                            const float* jl, const float* h, float* x, int B,
                            int Z, int m, float gamma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (B + kTileMembers - 1) / kTileMembers;
#define RMT_LAUNCH(MM)                                                  \
  real_kernel<MM><<<grid, dim3(kTileMembers, MM), 0, s>>>(              \
      e, minv_r, jl, h, x, B, Z, gamma)
  RMT_DISPATCH_M(m, RMT_LAUNCH)
#undef RMT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
