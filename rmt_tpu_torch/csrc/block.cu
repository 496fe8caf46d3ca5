// Exact block-bidiagonal Radau stage solves for the lockstep ensemble,
// hand-written for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by rmt_tpu_torch/ops/cuda_block.py, whose plain-PyTorch twins compute
// the same functions in the same order.
//
// Replaces the TPU Pallas kernels of rmt_tpu/ops/pallas_block.py:
//   block_factor     <- pallas_block.block_factor (_factor_kernel,
//                       _gj_inverse, _matmat)
//   block_apply      <- pallas_block.block_apply (_apply_kernel, _matvec)
//   block_apply_real <- pallas_block.block_apply_real (_real_kernel)
//
// Layouts are member-last, exactly as on the TPU: matrices (z, m, m, B),
// stage vectors (3, m, z, B), vectors (m, z, B). The member index is the
// fastest-moving axis, so a warp whose lanes are neighbouring members
// reads whole 128-byte lines on every load.
//
// What bounds them on an H100. block_apply moves every Minv and Jl block
// once (78 MB at B = 4096, m = 7, z = 20: 23 us at 3.35 TB/s) while its
// arithmetic is a recurrence over the z nodes, so it is bound by bytes
// if, and only if, enough of them are in flight. One thread per member
// would leave 100 of 132 SMs idle at B = 4096 and expose the node's seven
// dependent matvecs and their 392 loads. So a block takes a tile of 32
// members (kApplyMembers; apply_geometry in ops/cuda_block.py) with m
// warps' worth of threads: thread (lane, i) owns row i of every block
// and variable i of every vector of member b0 + lane. Each load of
// a matrix entry (i, j) is one line for the warp; a node's blocks and R
// slab (4m + 3 loads a thread) are fetched two nodes ahead into
// registers while a node computes; the recurrence vectors pass between rows
// through shared memory, with the real and the complex recurrence in the
// same two phases (two barriers a node). Each row's dot product keeps
// the j order of the twin, so the result is bit for bit the twin's.
// block_apply_real still runs one thread per member (a sequential
// recurrence over the nodes, latency-bound at low occupancy), and
// block_factor one thread per member and node: three 7x7 Gauss-Jordan
// inversions with ~200 live floats, so register pressure limits
// occupancy. Both keep every intermediate in registers (fully unrolled
// over the compile-time block size M, so row swaps are selects, never
// dynamic indexing) and read each matrix from device memory once per
// call.
//
// Numerics: partial pivoting takes the FIRST maximum (ties go to the
// lowest row), as the TPU kernel does. Built with -fmad=false so each
// product and sum rounds like the twin's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// block_apply's members a block: a warp's lanes, so a warp's load of one
// matrix entry is one 128-byte line (cuda_block.apply_geometry)
constexpr int kApplyMembers = 32;

template <int M>
__device__ __forceinline__ void gj_inverse(float (&A)[M][2 * M]) {
  // A = [M | I] on entry, [I | M^-1] on exit
#pragma unroll
  for (int col = 0; col < M; ++col) {
    float best = fabsf(A[col][col]);
    int piv = col;
#pragma unroll
    for (int r = col + 1; r < M; ++r) {
      float mg = fabsf(A[r][col]);
      if (mg > best) {
        best = mg;
        piv = r;
      }
    }
    float prow[2 * M];
#pragma unroll
    for (int j = 0; j < 2 * M; ++j) prow[j] = A[col][j];
#pragma unroll
    for (int r = col + 1; r < M; ++r) {
      const bool sw = (piv == r);
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) {
        const float a = A[r][j];
        const float c = A[col][j];
        prow[j] = sw ? a : prow[j];
        A[r][j] = sw ? c : a;
      }
    }
    const float pv = prow[col];
#pragma unroll
    for (int j = 0; j < 2 * M; ++j) prow[j] = prow[j] / pv;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (r == col) continue;
      const float f = A[r][col];
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) A[r][j] = A[r][j] - f * prow[j];
    }
#pragma unroll
    for (int j = 0; j < 2 * M; ++j) A[col][j] = prow[j];
  }
}

template <int M>
__device__ __forceinline__ void set_shifted(float (&A)[M][2 * M],
                                            const float (&J)[M][M],
                                            float s) {
  // A = [I - s*J | I]
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      A[i][j] = (i == j ? 1.0f : 0.0f) - s * J[i][j];
      A[i][M + j] = (i == j) ? 1.0f : 0.0f;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    factor_kernel(const float* __restrict__ jd, const float* __restrict__ h,
                  float* __restrict__ minv_r, float* __restrict__ minv_cr,
                  float* __restrict__ minv_ci, int B, int Z, float gamma,
                  float mu_r, float mu_i) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * Z) return;
  const int b = (int)(idx % B);
  const int z = (int)(idx / B);
  const long base = (long)z * M * M * B + b;
  auto at = [&](int i, int j) { return base + (long)(i * M + j) * B; };

  float J[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) J[i][j] = jd[at(i, j)];
  const float hb = h[b];
  const float g = gamma * hb;
  const float mr = mu_r * hb;
  const float mi = mu_i * hb;

  float A[M][2 * M];
  // real shift: (I - h*gamma*Jd)^-1
  set_shifted<M>(A, J, g);
  gj_inverse<M>(A);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) minv_r[at(i, j)] = A[i][M + j];

  // complex shift (Am + i Bm)^-1 with Am = I - h*mu_r*Jd, Bm = -h*mu_i*Jd,
  // from two real inversions: Y = (Am + Bm Am^-1 Bm)^-1 and
  // (Am + i Bm)^-1 = Y - i Am^-1 Bm Y
  const float nmi = 0.0f - mi;
  set_shifted<M>(A, J, mr);
  gj_inverse<M>(A);                       // X = Am^-1 in A[:, M:]
  float XB[M][M];                         // X @ Bm
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float acc = A[i][M] * (nmi * J[0][k]);
#pragma unroll
      for (int j = 1; j < M; ++j) acc = acc + A[i][M + j] * (nmi * J[j][k]);
      XB[i][k] = acc;
    }
  }
  // S = Am + Bm @ XB, inverted in place
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float acc = (nmi * J[i][0]) * XB[0][k];
#pragma unroll
      for (int j = 1; j < M; ++j) acc = acc + (nmi * J[i][j]) * XB[j][k];
      const float am = (i == k ? 1.0f : 0.0f) - mr * J[i][k];
      A[i][k] = am + acc;
      A[i][M + k] = (i == k) ? 1.0f : 0.0f;
    }
  }
  gj_inverse<M>(A);                       // Y in A[:, M:]
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      minv_cr[at(i, k)] = A[i][M + k];
      float acc = XB[i][0] * A[0][M + k];
#pragma unroll
      for (int j = 1; j < M; ++j) acc = acc + XB[i][j] * A[j][M + k];
      minv_ci[at(i, k)] = -acc;
    }
  }
}

// y = Mz @ x for one member; Mz rows at mat + ((i*M + j) * B)
template <int M>
__device__ __forceinline__ void matvec(const float* __restrict__ mat, long B,
                                       const float (&x)[M], float (&y)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float acc = mat[(long)(i * M) * B] * x[0];
#pragma unroll
    for (int j = 1; j < M; ++j) acc = acc + mat[(long)(i * M + j) * B] * x[j];
    y[i] = acc;
  }
}

struct ApplyCoef {
  float w0[3], w1r[3], w1i[3];  // rows of T^-1 (real row 0, complex row 1)
  float c0[3], c1[3], c2[3];    // dK_i = c0 z0 + c1 Re z1 - c2 Im z1
  float gamma, mu_r, mu_i;
};

// node z's operands of thread (lane, i): row i of Jl_z, Minv_r_z,
// Minv_cr_z and Minv_ci_z, and variable i of the three R stages
template <int M>
struct NodeRow {
  float jl[M], mr[M], mcr[M], mci[M], r[3];
};

template <int M>
__device__ __forceinline__ void load_node(NodeRow<M>& o, const float* r,
                                          const float* minv_r,
                                          const float* minv_cr,
                                          const float* minv_ci,
                                          const float* jl, long row,
                                          long rvec, long sB, int z, int Z) {
  const long at = z * (long)M * M * sB + row;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    o.jl[j] = __ldg(jl + at + j * sB);
    o.mr[j] = __ldg(minv_r + at + j * sB);
    o.mcr[j] = __ldg(minv_cr + at + j * sB);
    o.mci[j] = __ldg(minv_ci + at + j * sB);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
    o.r[s] = __ldg(r + rvec + ((long)s * M * Z + z) * sB);
}

// row . x in the twin's order: acc = a[0] x[0]; acc = acc + a[j] x[j]
template <int M>
__device__ __forceinline__ float rowdot(const float (&a)[M],
                                        const float (*x)[kApplyMembers],
                                        int lane) {
  float acc = a[0] * x[0][lane];
#pragma unroll
  for (int j = 1; j < M; ++j) acc = acc + a[j] * x[j][lane];
  return acc;
}

template <int M>
__global__ void __launch_bounds__(M * kApplyMembers)
    apply_kernel(const float* __restrict__ r, const float* __restrict__ minv_r,
                 const float* __restrict__ minv_cr,
                 const float* __restrict__ minv_ci,
                 const float* __restrict__ jl, const float* __restrict__ h,
                 float* __restrict__ dk, int B, int Z, ApplyCoef c) {
  constexpr int TB = kApplyMembers;
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

  // nodes z, z + 1 and z + 2: two nodes' loads in flight while one computes
  NodeRow<M> cur, nxt, far;
  load_node<M>(cur, r, minv_r, minv_cr, minv_ci, jl, row, rvec, sB, 0, Z);
  if (Z > 1)
    load_node<M>(nxt, r, minv_r, minv_cr, minv_ci, jl, row, rvec, sB, 1, Z);
  s_x0[i][lane] = s_x1r[i][lane] = s_x1i[i][lane] = 0.0f;
  __syncthreads();
  for (int z = 0; z < Z; ++z) {
    if (z + 2 < Z)
      load_node<M>(far, r, minv_r, minv_cr, minv_ci, jl, row, rvec, sB,
                   z + 2, Z);
    const float r0 = cur.r[0], r1 = cur.r[1], r2 = cur.r[2];
    const float w0 = (c.w0[0] * r0 + c.w0[1] * r1) + c.w0[2] * r2;
    const float w1r = (c.w1r[0] * r0 + c.w1r[1] * r1) + c.w1r[2] * r2;
    const float w1i = (c.w1i[0] * r0 + c.w1i[1] * r1) + c.w1i[2] * r2;
    // phase 1: h*mu*Jl_z x_{z-1} for the real and the complex recurrence
    const float t = rowdot<M>(cur.jl, s_x0, lane);
    const float ur = rowdot<M>(cur.jl, s_x1r, lane);
    const float ui = rowdot<M>(cur.jl, s_x1i, lane);
    s_t[i][lane] = w0 + g * t;
    s_rr[i][lane] = (w1r + mr * ur) - mi * ui;
    s_ri[i][lane] = (w1i + mr * ui) + mi * ur;
    __syncthreads();
    // phase 2: x_z = Minv_z (...), real and (Mc_r + i Mc_i) complex
    const float x0 = rowdot<M>(cur.mr, s_t, lane);
    const float x1r = rowdot<M>(cur.mcr, s_rr, lane) -
                      rowdot<M>(cur.mci, s_ri, lane);
    const float x1i = rowdot<M>(cur.mcr, s_ri, lane) +
                      rowdot<M>(cur.mci, s_rr, lane);
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
    cur = nxt;
    nxt = far;
    __syncthreads();
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    real_kernel(const float* __restrict__ e, const float* __restrict__ minv_r,
                const float* __restrict__ jl, const float* __restrict__ h,
                float* __restrict__ x, int B, int Z, float gamma) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float g = gamma * h[b];
  const long sB = B;
  const long mat_stride = (long)M * M * B;
  float xp[M];
#pragma unroll
  for (int v = 0; v < M; ++v) xp[v] = 0.0f;
  for (int z = 0; z < Z; ++z) {
    float t[M], xn[M];
    matvec<M>(jl + z * mat_stride + b, sB, xp, t);
#pragma unroll
    for (int v = 0; v < M; ++v)
      t[v] = e[((long)v * Z + z) * sB + b] + g * t[v];
    matvec<M>(minv_r + z * mat_stride + b, sB, t, xn);
#pragma unroll
    for (int v = 0; v < M; ++v) {
      x[((long)v * Z + z) * sB + b] = xn[v];
      xp[v] = xn[v];
    }
  }
}

inline int blocks_for(long n) { return (int)((n + kThreads - 1) / kThreads); }

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
  cudaStream_t s = (cudaStream_t)stream;
#define RMT_LAUNCH(MM)                                                   \
  factor_kernel<MM><<<blocks_for(n), kThreads, 0, s>>>(                  \
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
  const int grid = (B + kApplyMembers - 1) / kApplyMembers;
#define RMT_LAUNCH(MM)                                                  \
  apply_kernel<MM><<<grid, dim3(kApplyMembers, MM), 0, s>>>(            \
      r, minv_r, minv_cr, minv_ci, jl, h, dk, B, Z, c)
  RMT_DISPATCH_M(m, RMT_LAUNCH)
#undef RMT_LAUNCH
  return (int)cudaGetLastError();
}

int block_apply_real_launch(const float* e, const float* minv_r,
                            const float* jl, const float* h, float* x, int B,
                            int Z, int m, float gamma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RMT_LAUNCH(MM)                                                 \
  real_kernel<MM><<<blocks_for(B), kThreads, 0, s>>>(e, minv_r, jl, h, \
                                                      x, B, Z, gamma)
  RMT_DISPATCH_M(m, RMT_LAUNCH)
#undef RMT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
