// Fused Newton-Schulz preconditioner update for the lockstep ensemble,
// hand-written for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by rmt_tpu_torch/ops/cuda_ns.py, whose plain-PyTorch twin computes the
// same function with torch.matmul.
//
// Replaces the TPU Pallas kernel rmt_tpu/ops/pallas_ns.py::ns_fused_step
// (_kernel). For one ensemble member and one iterate (Pr, Pcr + i Pci) of
// the inverses of Mr = I - h*gamma*J and Mc = I - h*(mu_r + i mu_i)*J:
//
//   phase 1:  JP = J Pr, JPr = J Pcr, JPi = J Pci           (3 products)
//             MPr   = Pr  - g*JP
//             MPc_r = Pcr - (mr*JPr - mi*JPi)
//             MPc_i = Pci - (mr*JPi + mi*JPr)
//             rho = max(|I - MPr|_F, |I - MPc|_F) / sqrt(n)  of the INPUT
//   phase 2:  Pr'  = 2 Pr  - Pr MPr                          (5 products)
//             Pcr' = 2 Pcr - (Pcr MPc_r - Pci MPc_i)
//             Pci' = 2 Pci - (Pci MPc_r + Pcr MPc_i)
//
// What bounds it on an H100: operations. A member at n = 140 is
// 8 * 2 * n^3 = 43.9 MFLOP against 7 matrices of 78 KB moved, so float32
// FFMA issue (67 TFLOP/s outside the tensor cores) is the limit, not the
// 3.35 TB/s of device memory. The arithmetic is float32 FFMA only: the
// Newton-Schulz certificate needs full float32 products.
//
// Design. The TPU kernel keeps a member's four operands and every
// intermediate in VMEM (about 1 MB); a Hopper block has 227 KB, and the
// operands alone are 314 KB, so the work is tiled instead. One block of
// 16 x 16 threads per member walks the 48 x 48 output tiles of each phase
// (n = 140 -> 3 x 3 tiles, 6% padding) with a k-slab of 16 staged through
// shared memory; a thread holds a 3 x 3 micro-tile, strided by 16 so that
// shared-memory reads are broadcasts or conflict-free. All products of a
// phase that share an operand run in the same pass: phase 1 reads each J
// slab once for its three products (27 accumulators a thread), phase 2
// forms the real and the complex update in one pass (27 accumulators).
// The three MP intermediates go through a scratch (B, 3, n, n) in device
// memory between the phases (written and read by the same block, so they
// mostly stay in L2); __syncthreads() orders those global writes before
// the reads of phase 2. The Frobenius sums are reduced per thread in tile
// order and then by a shared-memory tree in a fixed order: no float
// atomics, so rho is reproducible from run to run. Edges are guarded:
// out-of-range tile entries are staged as zeros and never stored, so any
// n works (n = 24, 80, 140 are exercised).
//
// Outputs must not alias inputs: phase 2 reads Pr, Pcr, Pci while the
// updated iterates are written.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 48;      // output tile edge
constexpr int kSlab = 16;      // k depth staged per step
constexpr int kT = 16;         // threads per tile edge
constexpr int kMicro = 3;      // micro-tile edge (kTile / kT)
constexpr int kThreads = kT * kT;
constexpr int kPadA = kTile + 1;   // A slabs are stored k-major, padded

// Stage rows [i0, i0 + kTile) x cols [k0, k0 + kSlab) of the row-major
// n x n matrix X as As[k][i] (zeros outside the matrix).
__device__ __forceinline__ void stage_a(const float* X, int n, int i0, int k0,
                                        float (*As)[kPadA], int t) {
  const int kk = t % kSlab;
  const int ii = t / kSlab;
#pragma unroll
  for (int q = 0; q < kMicro; ++q) {
    const int i = ii + kT * q;
    const int gi = i0 + i, gk = k0 + kk;
    As[kk][i] = (gi < n && gk < n) ? X[(size_t)gi * n + gk] : 0.0f;
  }
}

// Stage rows [k0, k0 + kSlab) x cols [j0, j0 + kTile) of X as Bs[k][j].
__device__ __forceinline__ void stage_b(const float* X, int n, int k0, int j0,
                                        float (*Bs)[kTile], int t) {
#pragma unroll
  for (int q = 0; q < kMicro; ++q) {
    const int e = t + kThreads * q;
    const int k = e / kTile, j = e % kTile;
    const int gk = k0 + k, gj = j0 + j;
    Bs[k][j] = (gk < n && gj < n) ? X[(size_t)gk * n + gj] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ns_step_kernel(const float* __restrict__ Jg, const float* __restrict__ Prg,
                   const float* __restrict__ Pcrg,
                   const float* __restrict__ Pcig,
                   const float* __restrict__ hg, float* scratch,
                   float* __restrict__ pr_out, float* __restrict__ pcr_out,
                   float* __restrict__ pci_out, float* __restrict__ rho_out,
                   int n, float gamma, float mu_r, float mu_i) {
  __shared__ float As[3][kSlab][kPadA];
  __shared__ float Bs[3][kSlab][kTile];
  __shared__ float red[3][kThreads];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int tx = t % kT, ty = t / kT;
  const size_t nn = (size_t)n * n;
  const float* J = Jg + b * nn;
  const float* Pr = Prg + b * nn;
  const float* Pcr = Pcrg + b * nn;
  const float* Pci = Pcig + b * nn;
  // the MP intermediates are written in phase 1 and read in phase 2 by
  // this block: plain pointers, never the read-only data path
  float* MPr = scratch + (size_t)b * 3 * nn;
  float* MPcr = MPr + nn;
  float* MPci = MPcr + nn;

  const float h = hg[b];
  const float g = gamma * h;
  const float mr = mu_r * h;
  const float mi = mu_i * h;
  const int tiles = (n + kTile - 1) / kTile;

  // ---- phase 1: J [Pr | Pcr | Pci], the M P assembly, the residual ----
  float s_r = 0.0f, s_c = 0.0f, s_i = 0.0f;
  for (int ti = 0; ti < tiles; ++ti) {
    for (int tj = 0; tj < tiles; ++tj) {
      const int i0 = ti * kTile, j0 = tj * kTile;
      float acc[3][kMicro][kMicro];
#pragma unroll
      for (int o = 0; o < 3; ++o)
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
#pragma unroll
          for (int c = 0; c < kMicro; ++c) acc[o][r][c] = 0.0f;

      for (int k0 = 0; k0 < n; k0 += kSlab) {
        stage_a(J, n, i0, k0, As[0], t);
        stage_b(Pr, n, k0, j0, Bs[0], t);
        stage_b(Pcr, n, k0, j0, Bs[1], t);
        stage_b(Pci, n, k0, j0, Bs[2], t);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kSlab; ++k) {
          float a[kMicro], bv[3][kMicro];
#pragma unroll
          for (int r = 0; r < kMicro; ++r) a[r] = As[0][k][ty + kT * r];
#pragma unroll
          for (int o = 0; o < 3; ++o)
#pragma unroll
            for (int c = 0; c < kMicro; ++c) bv[o][c] = Bs[o][k][tx + kT * c];
#pragma unroll
          for (int o = 0; o < 3; ++o)
#pragma unroll
            for (int r = 0; r < kMicro; ++r)
#pragma unroll
              for (int c = 0; c < kMicro; ++c)
                acc[o][r][c] += a[r] * bv[o][c];
        }
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int i = i0 + ty + kT * r, j = j0 + tx + kT * c;
          if (i < n && j < n) {
            const size_t at = (size_t)i * n + j;
            const float jp = acc[0][r][c];
            const float jpr = acc[1][r][c];
            const float jpi = acc[2][r][c];
            const float mpr = Pr[at] - g * jp;
            const float mpcr = Pcr[at] - (mr * jpr - mi * jpi);
            const float mpci = Pci[at] - (mr * jpi + mi * jpr);
            MPr[at] = mpr;
            MPcr[at] = mpcr;
            MPci[at] = mpci;
            const float e = (i == j) ? 1.0f : 0.0f;
            const float dr = e - mpr;
            const float dc = e - mpcr;
            s_r += dr * dr;
            s_c += dc * dc;
            s_i += mpci * mpci;
          }
        }
      }
    }
  }

  // Frobenius sums over the block, in a fixed order
  red[0][t] = s_r;
  red[1][t] = s_c;
  red[2][t] = s_i;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[0][t] += red[0][t + s];
      red[1][t] += red[1][t + s];
      red[2][t] += red[2][t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    const float inv_n = 1.0f / (float)n;
    const float res_r = sqrtf(red[0][0] * inv_n);
    const float res_c = sqrtf((red[1][0] + red[2][0]) * inv_n);
    // a NaN on either side must reach the certificate (fmaxf drops it)
    rho_out[b] = (res_r > res_c || res_r != res_r) ? res_r : res_c;
  }
  // the barriers of the reduction also order this block's MP stores
  // before the loads of phase 2

  // ---- phase 2: P (M P), real and complex, and the update ----
  for (int ti = 0; ti < tiles; ++ti) {
    for (int tj = 0; tj < tiles; ++tj) {
      const int i0 = ti * kTile, j0 = tj * kTile;
      float ar_[kMicro][kMicro], acr_[kMicro][kMicro], aci_[kMicro][kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          ar_[r][c] = 0.0f;
          acr_[r][c] = 0.0f;
          aci_[r][c] = 0.0f;
        }

      for (int k0 = 0; k0 < n; k0 += kSlab) {
        stage_a(Pr, n, i0, k0, As[0], t);
        stage_a(Pcr, n, i0, k0, As[1], t);
        stage_a(Pci, n, i0, k0, As[2], t);
        stage_b(MPr, n, k0, j0, Bs[0], t);
        stage_b(MPcr, n, k0, j0, Bs[1], t);
        stage_b(MPci, n, k0, j0, Bs[2], t);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kSlab; ++k) {
          float a[3][kMicro], bv[3][kMicro];
#pragma unroll
          for (int o = 0; o < 3; ++o) {
#pragma unroll
            for (int r = 0; r < kMicro; ++r) a[o][r] = As[o][k][ty + kT * r];
#pragma unroll
            for (int c = 0; c < kMicro; ++c) bv[o][c] = Bs[o][k][tx + kT * c];
          }
#pragma unroll
          for (int r = 0; r < kMicro; ++r)
#pragma unroll
            for (int c = 0; c < kMicro; ++c) {
              ar_[r][c] += a[0][r] * bv[0][c];
              // (Pcr + i Pci)(MPc_r + i MPc_i)
              acr_[r][c] += a[1][r] * bv[1][c];
              acr_[r][c] -= a[2][r] * bv[2][c];
              aci_[r][c] += a[2][r] * bv[1][c];
              aci_[r][c] += a[1][r] * bv[2][c];
            }
        }
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int i = i0 + ty + kT * r, j = j0 + tx + kT * c;
          if (i < n && j < n) {
            const size_t at = (size_t)i * n + j;
            pr_out[b * nn + at] = 2.0f * Pr[at] - ar_[r][c];
            pcr_out[b * nn + at] = 2.0f * Pcr[at] - acr_[r][c];
            pci_out[b * nn + at] = 2.0f * Pci[at] - aci_[r][c];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on the caller's stream and returns cudaGetLastError() (0 on
// success); nothing synchronises. J, Pr, Pcr, Pci, the three outputs:
// (B, n, n) float32; h, rho: (B,); scratch: (B, 3, n, n).
int ns_fused_step_launch(const float* J, const float* Pr, const float* Pcr,
                         const float* Pci, const float* h, float* scratch,
                         float* pr_out, float* pcr_out, float* pci_out,
                         float* rho, int B, int n, float gamma, float mu_r,
                         float mu_i, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  ns_step_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      J, Pr, Pcr, Pci, h, scratch, pr_out, pcr_out, pci_out, rho, n, gamma,
      mu_r, mu_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
