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
// What bounds it on an H100: operations (16 n^3 a member, 0.15 GFLOP at
// n = 210, against 7 n^2 floats moved), float32 FFMA only, as csrc/ns.cu.
// This is the simple route, correct at any n, not yet tuned.
//
// Design: the update splits into independent column panels of kW
// columns; MP[:, panel] needs only P[:, panel], and P'[:, panel] only
// MP[:, panel]. One block takes one (member, panel) pair, so the grid is
// (B, panels) and no block holds a whole member:
//
//   phase 1: row slabs of kRows rows; for each, k-tiles of J (kRows x kK)
//     and of the three P panels (kK x kW) stream through shared memory;
//     each thread keeps a 4 x 2 micro-tile of the three J P sums, forms
//     its MP entries, adds them to its Frobenius sums and writes them to
//     a device scratch (B, 3, n, n) that only this block reads back;
//   phase 2: after a barrier (which makes the block's scratch writes
//     visible to the block), row slabs again: k-tiles of the three P row
//     slabs and of the three MP panels from the scratch; each thread
//     writes 2P - P MP for its entries.
//
// Shared memory is 19.5 KB at every n. The block's Frobenius sums are
// reduced by a fixed shared-memory tree into (B, panels, 3) partial sums;
// a second kernel (one thread a member) adds the panels in order and
// forms rho: no float atomics, so repeats give the same bits.
// Entries outside the n x n matrix are staged as zeros and never stored.
// Outputs must not alias inputs: phase 2 reads Pr, Pcr, Pci while other
// panels' blocks write the updated iterates.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;          // columns of a panel
constexpr int kRows = 64;       // rows of a slab
constexpr int kK = 16;          // k depth of a staged tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 2 entries each
constexpr int kTR = 4;          // rows of a thread's micro-tile
constexpr int kTC = 2;          // columns of a thread's micro-tile

// X[i][j] of the row-major n x n matrix X, zero outside it.
__device__ __forceinline__ float at(const float* X, int n, int i, int j) {
  return (i < n && j < n) ? X[(size_t)i * n + j] : 0.0f;
}

// Rows [r0, r0 + kRows) x columns [k0, k0 + kK) of X into dst[i][k]
// (row stride kK + 1).
__device__ __forceinline__ void stage_rows(const float* X, float* dst,
                                           int n, int r0, int k0) {
  for (int e = threadIdx.x; e < kRows * kK; e += kThreads) {
    const int i = e / kK, k = e % kK;
    dst[i * (kK + 1) + k] = at(X, n, r0 + i, k0 + k);
  }
}

// Rows [k0, k0 + kK) x columns [j0, j0 + kW) of X into dst[k][c].
__device__ __forceinline__ void stage_panel(const float* X, float* dst,
                                            int n, int k0, int j0) {
  for (int e = threadIdx.x; e < kK * kW; e += kThreads) {
    const int k = e / kW, c = e % kW;
    dst[k * kW + c] = at(X, n, k0 + k, j0 + c);
  }
}

__global__ void __launch_bounds__(kThreads)
    ns_wide_kernel(const float* __restrict__ Jg, const float* __restrict__ Prg,
                   const float* __restrict__ Pcrg,
                   const float* __restrict__ Pcig,
                   const float* __restrict__ hg, float* __restrict__ pr_out,
                   float* __restrict__ pcr_out, float* __restrict__ pci_out,
                   float* mp, float* __restrict__ partial, int n,
                   float gamma, float mu_r, float mu_i) {
  __shared__ float As[3][kRows * (kK + 1)];
  __shared__ float Bs[3][kK * kW];
  __shared__ float red[3][kThreads];

  const int m = blockIdx.x, p = blockIdx.y, panels = gridDim.y;
  const int j0 = p * kW;
  const int t = threadIdx.x;
  const int tr = kTR * (t / (kW / kTC)), tc = kTC * (t % (kW / kTC));
  const size_t nn = (size_t)n * n;
  const float* J = Jg + m * nn;
  const float* P[3] = {Prg + m * nn, Pcrg + m * nn, Pcig + m * nn};
  float* out[3] = {pr_out + m * nn, pcr_out + m * nn, pci_out + m * nn};
  float* MP[3] = {mp + (3 * (size_t)m) * nn, mp + (3 * (size_t)m + 1) * nn,
                  mp + (3 * (size_t)m + 2) * nn};
  const float h = hg[m];
  const float g = gamma * h, mr = mu_r * h, mi = mu_i * h;

  // ---- phase 1: J [Pr | Pcr | Pci] on the panel, MP, the residual ----
  float s_r = 0.0f, s_c = 0.0f, s_i = 0.0f;
  for (int r0 = 0; r0 < n; r0 += kRows) {
    float acc[3][kTR][kTC] = {};
    for (int k0 = 0; k0 < n; k0 += kK) {
      stage_rows(J, As[0], n, r0, k0);
#pragma unroll
      for (int o = 0; o < 3; ++o) stage_panel(P[o], Bs[o], n, k0, j0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        float a[kTR];
#pragma unroll
        for (int r = 0; r < kTR; ++r) a[r] = As[0][(tr + r) * (kK + 1) + k];
#pragma unroll
        for (int o = 0; o < 3; ++o)
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
            const float b = Bs[o][k * kW + tc + c];
#pragma unroll
            for (int r = 0; r < kTR; ++r)
              acc[o][r][c] = fmaf(a[r], b, acc[o][r][c]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int i = r0 + tr + r, j = j0 + tc + c;
        if (i >= n || j >= n) continue;
        const size_t ij = (size_t)i * n + j;
        const float jp = acc[0][r][c], jpr = acc[1][r][c],
                    jpi = acc[2][r][c];
        const float mpr = P[0][ij] - g * jp;
        const float mpcr = P[1][ij] - (mr * jpr - mi * jpi);
        const float mpci = P[2][ij] - (mr * jpi + mi * jpr);
        const float e = (i == j) ? 1.0f : 0.0f;
        const float dr = e - mpr, dc = e - mpcr;
        s_r += dr * dr;
        s_c += dc * dc;
        s_i += mpci * mpci;
        MP[0][ij] = mpr;
        MP[1][ij] = mpcr;
        MP[2][ij] = mpci;
      }
  }
  // the barrier also orders the block's scratch writes before its reads
  __syncthreads();

  // ---- phase 2: P (M P) on the panel, real and complex, the update ----
  for (int r0 = 0; r0 < n; r0 += kRows) {
    float ar[kTR][kTC] = {}, acr[kTR][kTC] = {}, aci[kTR][kTC] = {};
    for (int k0 = 0; k0 < n; k0 += kK) {
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        stage_rows(P[o], As[o], n, r0, k0);
        stage_panel(MP[o], Bs[o], n, k0, j0);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        float a[3][kTR], b[3][kTC];
#pragma unroll
        for (int o = 0; o < 3; ++o) {
#pragma unroll
          for (int r = 0; r < kTR; ++r)
            a[o][r] = As[o][(tr + r) * (kK + 1) + k];
#pragma unroll
          for (int c = 0; c < kTC; ++c) b[o][c] = Bs[o][k * kW + tc + c];
        }
#pragma unroll
        for (int r = 0; r < kTR; ++r)
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
            ar[r][c] = fmaf(a[0][r], b[0][c], ar[r][c]);
            // (Pcr + i Pci)(MPc_r + i MPc_i)
            acr[r][c] = fmaf(a[1][r], b[1][c], acr[r][c]);
            acr[r][c] = fmaf(-a[2][r], b[2][c], acr[r][c]);
            aci[r][c] = fmaf(a[2][r], b[1][c], aci[r][c]);
            aci[r][c] = fmaf(a[1][r], b[2][c], aci[r][c]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int i = r0 + tr + r, j = j0 + tc + c;
        if (i >= n || j >= n) continue;
        const size_t ij = (size_t)i * n + j;
        out[0][ij] = 2.0f * P[0][ij] - ar[r][c];
        out[1][ij] = 2.0f * P[1][ij] - acr[r][c];
        out[2][ij] = 2.0f * P[2][ij] - aci[r][c];
      }
  }

  // the panel's Frobenius sums over the block, in a fixed order
  red[0][t] = s_r;
  red[1][t] = s_c;
  red[2][t] = s_i;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int o = 0; o < 3; ++o) red[o][t] += red[o][t + s];
    }
    __syncthreads();
  }
  if (t < 3) partial[((size_t)m * panels + p) * 3 + t] = red[t][0];
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

}  // namespace

extern "C" {

// Launches both kernels on the caller's stream and returns a cudaError_t
// (0 on success); nothing synchronises. J, Pr, Pcr, Pci, the three
// outputs: (B, n, n) float32; h, rho: (B,); mp: (B, 3, n, n) scratch;
// partial: (B, panels, 3) scratch, panels = ceil(n / 32) (cuda_ns.
// wide_geometry).
int ns_wide_step_launch(const float* J, const float* Pr, const float* Pcr,
                        const float* Pci, const float* h, float* pr_out,
                        float* pcr_out, float* pci_out, float* rho,
                        float* mp, float* partial, int B, int n, int panels,
                        float gamma, float mu_r, float mu_i, void* stream) {
  if (B <= 0 || n <= 0 || panels > 65535 || panels != (n + kW - 1) / kW)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  ns_wide_kernel<<<dim3(B, panels), kThreads, 0, s>>>(
      J, Pr, Pcr, Pci, h, pr_out, pcr_out, pci_out, mp, partial, n, gamma,
      mu_r, mu_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ns_wide_rho_kernel<<<(B + 127) / 128, 128, 0, s>>>(partial, rho, B, n,
                                                     panels);
  return (int)cudaGetLastError();
}

}  // extern "C"
