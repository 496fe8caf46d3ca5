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
// stage vectors (3, m, z, B), vectors (m, z, B). On Hopper the natural
// shape is one thread per member (per member and node for the factor):
// the member index is the fastest-moving axis, so a warp's 32 threads
// read 32 neighbouring floats on every load.
//
// What bounds them on an H100: these are latency-bound, not bandwidth- or
// FLOP-bound. block_apply / block_apply_real run one thread per member
// with a sequential recurrence over the z nodes, so at B = 4096 the grid
// is 32 blocks of 128 threads on a 132-SM card (a quarter of the SMs,
// one warp scheduler slot each): the dependent 7x7 matvec chain per node
// is exposed. block_factor has z*B = 81,920 threads but each runs three
// 7x7 Gauss-Jordan inversions with ~200 live floats, so register
// pressure limits occupancy. The design keeps every intermediate in
// registers (fully unrolled over the compile-time block size M, so row
// swaps are selects, never dynamic indexing) and reads each matrix from
// device memory once per call. Splitting the recurrence across threads
// (a parallel scan over z, or a warp per member) is the redesign a later
// change should measure.
//
// Numerics: partial pivoting takes the FIRST maximum (ties go to the
// lowest row), as the TPU kernel does. Built with -fmad=false so each
// product and sum rounds like the twin's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

template <int M>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const float* __restrict__ r, const float* __restrict__ minv_r,
                 const float* __restrict__ minv_cr,
                 const float* __restrict__ minv_ci,
                 const float* __restrict__ jl, const float* __restrict__ h,
                 float* __restrict__ dk, int B, int Z, ApplyCoef c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float hb = h[b];
  const float g = c.gamma * hb;
  const float mr = c.mu_r * hb;
  const float mi = c.mu_i * hb;
  const long sB = B;
  const long mat_stride = (long)M * M * B;  // one node's block
  auto rv = [&](int s, int v, int z) {
    return ((long)(s * M + v) * Z + z) * sB + b;
  };

  float x0p[M], x1rp[M], x1ip[M];
#pragma unroll
  for (int v = 0; v < M; ++v) x0p[v] = x1rp[v] = x1ip[v] = 0.0f;

  for (int z = 0; z < Z; ++z) {
    float w0[M], w1r[M], w1i[M];
#pragma unroll
    for (int v = 0; v < M; ++v) {
      const float r0 = r[rv(0, v, z)], r1 = r[rv(1, v, z)],
                  r2 = r[rv(2, v, z)];
      w0[v] = (c.w0[0] * r0 + c.w0[1] * r1) + c.w0[2] * r2;
      w1r[v] = (c.w1r[0] * r0 + c.w1r[1] * r1) + c.w1r[2] * r2;
      w1i[v] = (c.w1i[0] * r0 + c.w1i[1] * r1) + c.w1i[2] * r2;
    }
    const float* jlz = jl + z * mat_stride + b;
    // real recurrence: x_z = Minv_z (w_z + h*gamma*Jl_z x_{z-1})
    float t[M], x0[M];
    matvec<M>(jlz, sB, x0p, t);
#pragma unroll
    for (int v = 0; v < M; ++v) t[v] = w0[v] + g * t[v];
    matvec<M>(minv_r + z * mat_stride + b, sB, t, x0);
    // complex recurrence with (Mc_r + i Mc_i)
    float ur[M], ui[M], rr[M], ri[M];
    matvec<M>(jlz, sB, x1rp, ur);
    matvec<M>(jlz, sB, x1ip, ui);
#pragma unroll
    for (int v = 0; v < M; ++v) {
      rr[v] = (w1r[v] + mr * ur[v]) - mi * ui[v];
      ri[v] = (w1i[v] + mr * ui[v]) + mi * ur[v];
    }
    float a[M], bb[M], x1r[M], x1i[M];
    const float* mcr = minv_cr + z * mat_stride + b;
    const float* mci = minv_ci + z * mat_stride + b;
    matvec<M>(mcr, sB, rr, a);
    matvec<M>(mci, sB, ri, bb);
#pragma unroll
    for (int v = 0; v < M; ++v) x1r[v] = a[v] - bb[v];
    matvec<M>(mcr, sB, ri, a);
    matvec<M>(mci, sB, rr, bb);
#pragma unroll
    for (int v = 0; v < M; ++v) x1i[v] = a[v] + bb[v];
    // dK = Re(T Z), Z = [z0, z1, conj(z1)]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int v = 0; v < M; ++v) {
        dk[rv(i, v, z)] = (c.c0[i] * x0[v] + c.c1[i] * x1r[v]) -
                          c.c2[i] * x1i[v];
      }
    }
#pragma unroll
    for (int v = 0; v < M; ++v) {
      x0p[v] = x0[v];
      x1rp[v] = x1r[v];
      x1ip[v] = x1i[v];
    }
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
#define RMT_LAUNCH(MM)                                               \
  apply_kernel<MM><<<blocks_for(B), kThreads, 0, s>>>(               \
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
