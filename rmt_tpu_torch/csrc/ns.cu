// Fused Newton-Schulz preconditioner update for the lockstep ensemble,
// hand-written for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by rmt_tpu_torch/ops/cuda_ns.py, whose plain-PyTorch twin computes the
// same function with torch.matmul.
//
// Replaces the TPU Pallas kernel rmt_tpu/ops/pallas_ns.py::ns_fused_step
// (_kernel). For one ensemble member and one iterate (Pr, Pcr + i Pci) of
// the inverses of Mr = I - h*gamma*J and Mc = I - h*(mu_r + i mu_i)*J:
//
//   MPr   = Pr  - g*J Pr                                  (3 J-products)
//   MPc_r = Pcr - (mr*J Pcr - mi*J Pci)
//   MPc_i = Pci - (mr*J Pci + mi*J Pcr)
//   rho   = max(|I - MPr|_F, |I - MPc|_F) / sqrt(n)       of the INPUT
//   Pr'   = 2 Pr  - Pr MPr                                (5 products)
//   Pcr'  = 2 Pcr - (Pcr MPc_r - Pci MPc_i)
//   Pci'  = 2 Pci - (Pci MPc_r + Pcr MPc_i)
//
// What bounds it on an H100: operations. A member at n = 140 is
// 8 * 2 * n^3 = 43.9 MFLOP against 7 matrices of 78 KB moved, so float32
// FFMA issue (67 TFLOP/s outside the tensor cores) is the limit, not the
// 3.35 TB/s of device memory. The arithmetic is float32 FFMA only: the
// Newton-Schulz certificate needs full float32 products.
//
// Design: the update splits into independent column panels. For the
// columns jp of a panel, MP[:, jp] needs only P[:, jp], and P'[:, jp]
// needs only MP[:, jp]. A block walks the panels of a member (n = 140:
// three panels of 48 columns over 144 padded rows) and keeps a panel's
// three P panels and three MP intermediates in shared memory, so nothing
// but the outputs goes back to device memory:
//
//   phase 1 of a panel: k-slabs of J stream past the P panels; each
//     thread assembles its MP entries from its J P sums and the P entries
//     in the panel buffer, adds them to its Frobenius sums, and writes MP
//     to the other panel buffer;
//   phase 2 of the panel: k-slabs of Pr, Pcr and Pci (all rows) stream
//     past the MP panels; each thread writes 2P - P MP for its entries,
//     with P from the panel buffer. The MP buffer then takes the next
//     panel's P panels, so the two panel buffers swap roles each panel.
//
// Blocks stay resident (one per SM) and take members in turn, so the next
// member's first panel loads behind the current member's last epilogue.
// Every copy into shared memory is a 16-byte cp.async (4-byte copies only
// where n % 4 != 0), issued right after the one barrier of a step into
// the other slab buffer, so a slab's load hides behind the previous
// slab's FFMA. A slabs keep the rows of global memory (16 floats of k a
// row) with 8 floats of padding after every 8 rows, so the 8 rows of a
// thread are at fixed offsets and the three or four row groups of a warp
// fall in different banks.
//
// A thread holds an 8 x 4 micro-tile of each of three results (96
// accumulators). Phase 1 reads its A rows 4 k at a time (8 16-byte
// loads) and its 4 columns of each B panel per k (one 16-byte load):
// 20 loads for 384 FFMA; phase 2 reads A 2 k at a time: 30 loads for 320
// FFMA. Rows are padded to a multiple of the slab depth with zeros; the
// k-loop of the last slab stops at n rounded up to 4 (the terms it skips
// are fma(0, 0, acc) = acc). The Frobenius sums are kept per thread in
// panel and micro-tile order, then reduced by a shared-memory tree in a
// fixed order: no float atomics, so rho is the same bits on every run.
// Entries outside the n x n matrix are staged as zeros and never stored.
//
// The geometry (panel width, padded rows, threads, shared bytes) is
// chosen by the wrapper from n (cuda_ns.geometry) and checked here.
// Outputs must not alias inputs: phase 2 reads Pr, Pcr, Pci while the
// updated iterates are written.

#include <cuda_runtime.h>

namespace {

constexpr int kRM = 8;               // rows of a thread's micro-tile
constexpr int kCM = 4;               // columns of a thread's micro-tile
constexpr int kSlab = 16;            // k depth of a staged slab
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;     // a Hopper block's shared memory

// Offset of row i in an A slab: 16 floats a row, 8 more after every 8.
__device__ __forceinline__ int slab_row(int i) { return i * kSlab + (i >> 3) * 8; }
// Floats of one matrix's A slab with R rows (R a multiple of 8).
__device__ __forceinline__ int slab_size(int R) { return R * (kSlab + 1); }

// X[i][j .. j+3] of the row-major n x n matrix X, zeros outside it.
// vec: n % 4 == 0 and X 16-byte aligned, so a group is all in or all out.
__device__ __forceinline__ float4 ld4(const float* __restrict__ X, int n,
                                      int i, int j, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i >= n || j >= n) return v;
  const float* p = X + (size_t)i * n + j;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = p[0];
  if (j + 1 < n) v.y = p[1];
  if (j + 2 < n) v.z = p[2];
  if (j + 3 < n) v.w = p[3];
  return v;
}

__device__ __forceinline__ void st4(float* __restrict__ Y, int n, int i,
                                    int j, float4 v, bool vec) {
  if (i >= n || j >= n) return;
  float* p = Y + (size_t)i * n + j;
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (j + 1 < n) p[1] = v.y;
  if (j + 2 < n) p[2] = v.z;
  if (j + 3 < n) p[3] = v.w;
}

// Asynchronous copies into shared memory (cp.async): src_bytes = 0 fills
// the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's copy groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// X[i][j .. j+3] into dst[0 .. 3], zeros outside the n x n matrix.
__device__ __forceinline__ void copy4(float* dst, const float* __restrict__ X,
                                      int n, int i, int j, bool vec) {
  const float* src = X + (size_t)i * n + j;
  if (vec) {
    const bool in = i < n && j < n;
    cp_async16(dst, in ? src : X, in);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = i < n && j + u < n;
      cp_async4(dst + u, in ? src + u : X, in);
    }
  }
}

// Columns [j0, j0 + W) of rows [0, R) of X into dst[k][c] (row stride W).
__device__ __forceinline__ void stage_panel(const float* __restrict__ X,
                                            float* dst, int n, int R, int W,
                                            int j0, bool vec) {
  const int groups = W / 4;
  for (int e = threadIdx.x; e < R * groups; e += blockDim.x) {
    const int k = e / groups, c = 4 * (e % groups);
    copy4(dst + k * W + c, X, n, k, j0 + c, vec);
  }
}

// Rows [0, R) x columns [k0, k0 + kSlab) of X into an A slab (slab_row).
// Four lanes copy one row's 64 bytes.
__device__ __forceinline__ void stage_slab(const float* __restrict__ X,
                                           float* dst, int n, int R, int k0,
                                           bool vec) {
  for (int e = threadIdx.x; e < R * (kSlab / 4); e += blockDim.x) {
    const int q = 4 * (e % (kSlab / 4)), i = e / (kSlab / 4);
    copy4(dst + slab_row(i) + q, X, n, i, k0 + q, vec);
  }
}

__device__ __forceinline__ void frag4(const float* src, float (&b)[kCM]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
}

// Y[i][j .. j+3] = 2 X[i][j .. j+3] - acc[r] for the 8 rows i = row0 + r
// of a micro-tile, X from the panel buffer Xs (row stride W).
__device__ __forceinline__ void store_update(const float* Xs,
                                             float* __restrict__ Y, int n,
                                             int W, int row0, int col0, int j,
                                             const float (&acc)[kRM][kCM],
                                             bool vec) {
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const float4 x =
        *reinterpret_cast<const float4*>(Xs + (row0 + r) * W + col0);
    st4(Y, n, row0 + r, j,
        make_float4(2.0f * x.x - acc[r][0], 2.0f * x.y - acc[r][1],
                    2.0f * x.z - acc[r][2], 2.0f * x.w - acc[r][3]),
        vec);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    ns_step_kernel(const float* __restrict__ Jg, const float* __restrict__ Prg,
                   const float* __restrict__ Pcrg,
                   const float* __restrict__ Pcig,
                   const float* __restrict__ hg, float* __restrict__ pr_out,
                   float* __restrict__ pcr_out, float* __restrict__ pci_out,
                   float* __restrict__ rho_out, int B, int n, int tx, int ty,
                   int panels, int vec_ok, float gamma, float mu_r,
                   float mu_i) {
  extern __shared__ float4 smem4[];
  const int W = kCM * tx;            // panel width
  const int R = kRM * ty;            // padded rows, a multiple of kSlab
  const int mat = slab_size(R);      // one matrix's A slab
  float* Bps = reinterpret_cast<float*>(smem4);  // [2][3][R][W]
  float* As = Bps + 2 * 3 * R * W;               // [2 buffers][3 matrices]
  float* red = As + 2 * 3 * mat;                 // [3][blockDim.x]

  const int t = threadIdx.x;
  const bool vec = vec_ok != 0;
  const bool active = t < tx * ty;
  const int row0 = kRM * (t / tx), col0 = kCM * (t % tx);
  const int arow = slab_row(row0);   // the thread's rows in an A slab
  const size_t nn = (size_t)n * n;
  const int slabs = (n + kSlab - 1) / kSlab;
  const float* const Pg[3] = {Prg, Pcrg, Pcig};
  float* const outg[3] = {pr_out, pcr_out, pci_out};

  // A block stays resident and takes members blockIdx.x, + gridDim.x, ...
  // The copies run one step ahead of the arithmetic: after the barrier
  // that starts a step (every warp is done with the step before), the
  // next step's slab goes into the other slab buffer as one group. Panel
  // q of the block keeps its P panels in panel buffer q & 1 and writes
  // its MP to the other one, which, once phase 2 is done, takes the next
  // panel's P panels (this member's next columns or the next member's
  // first) while the epilogue stores.
  int m = blockIdx.x;
  if (m >= B) return;
#pragma unroll
  for (int o = 0; o < 3; ++o)
    stage_panel(Pg[o] + m * nn, Bps + o * R * W, n, R, W, 0, vec);
  stage_slab(Jg + m * nn, As, n, R, 0, vec);
  cp_async_commit();

  int buf = 0;
  int q = 0;
  for (; m < B; m += gridDim.x) {
    const float* J = Jg + m * nn;
    const float* P[3] = {Prg + m * nn, Pcrg + m * nn, Pcig + m * nn};
    const bool more = m + gridDim.x < B;
    const float h = hg[m];
    const float g = gamma * h;
    const float mr = mu_r * h;
    const float mi = mu_i * h;

    float s_r = 0.0f, s_c = 0.0f, s_i = 0.0f;
    for (int p = 0; p < panels; ++p, ++q) {
      const int j0 = p * W;
      float* Bp = Bps + (q & 1) * 3 * R * W;       // P, read by both phases
      float* Mp = Bps + ((q + 1) & 1) * 3 * R * W;  // MP, then the next P
      // the next panel: this member's next columns, or the next member's
      // first
      const bool last = p + 1 == panels;
      const bool has_next = !last || more;
      const size_t nx = last ? (size_t)(m + gridDim.x) * nn : (size_t)m * nn;
      const int jx = last ? 0 : j0 + W;

      // ---- phase 1: J [Pr | Pcr | Pci] on the panel, MP, the residual --
      float acc[3][kRM][kCM];
#pragma unroll
      for (int o = 0; o < 3; ++o)
#pragma unroll
        for (int r = 0; r < kRM; ++r)
#pragma unroll
          for (int c = 0; c < kCM; ++c) acc[o][r][c] = 0.0f;

      for (int s = 0; s < slabs; ++s) {
        cp_async_wait<0>();
        __syncthreads();
        float* next = As + (buf ^ 1) * 3 * mat;
        if (s + 1 < slabs) {
          stage_slab(J, next, n, R, (s + 1) * kSlab, vec);
        } else {   // phase 2's first slab
#pragma unroll
          for (int o = 0; o < 3; ++o)
            stage_slab(P[o], next + o * mat, n, R, 0, vec);
        }
        cp_async_commit();
        const float* A = As + buf * 3 * mat + arow;
        const float* Bk = Bp + s * kSlab * W + col0;
        // past n the slab holds zeros: fma(0, 0, acc) is acc, so stop at
        // n rounded up to 4
        const int kend = min(kSlab, (n - s * kSlab + 3) & ~3);
        if (active) {
#pragma unroll 2
          for (int k = 0; k < kend; k += 4) {
            float a[kRM][4];
#pragma unroll
            for (int r = 0; r < kRM; ++r) {
              const float4 v =
                  *reinterpret_cast<const float4*>(A + r * kSlab + k);
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

      // each thread reads its own P entries and writes its MP entries to
      // the other panel buffer (free since the last panel's epilogue; the
      // barrier of phase 2's first step orders these writes before any
      // read of them)
      if (active) {
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
#pragma unroll
          for (int c = 0; c < kCM; ++c) {
            const int i = row0 + r, j = j0 + col0 + c;
            const int at = (row0 + r) * W + col0 + c;
            const float jp = acc[0][r][c];
            const float jpr = acc[1][r][c];
            const float jpi = acc[2][r][c];
            float mpr = Bp[at] - g * jp;
            float mpcr = Bp[R * W + at] - (mr * jpr - mi * jpi);
            float mpci = Bp[2 * R * W + at] - (mr * jpi + mi * jpr);
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
            Mp[at] = mpr;
            Mp[R * W + at] = mpcr;
            Mp[2 * R * W + at] = mpci;
          }
        }
      }

      // ---- phase 2: P (M P) on the panel, real and complex, the update --
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
        cp_async_wait<0>();
        __syncthreads();
        float* next = As + (buf ^ 1) * 3 * mat;
        if (s + 1 < slabs) {
#pragma unroll
          for (int o = 0; o < 3; ++o)
            stage_slab(P[o], next + o * mat, n, R, (s + 1) * kSlab, vec);
        } else if (has_next) {   // the next panel's first J slab
          stage_slab(Jg + nx, next, n, R, 0, vec);
        }
        cp_async_commit();
        const float* A = As + buf * 3 * mat + arow;
        const float* Bk = Mp + s * kSlab * W + col0;
        const int kend = min(kSlab, (n - s * kSlab + 3) & ~3);
        if (active) {
#pragma unroll 2
          for (int k = 0; k < kend; k += 2) {
            float a[3][kRM][2];
#pragma unroll
            for (int o = 0; o < 3; ++o)
#pragma unroll
              for (int r = 0; r < kRM; ++r) {
                const float2 v = *reinterpret_cast<const float2*>(
                    A + o * mat + r * kSlab + k);
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
      __syncthreads();

      if (has_next) {   // the MP buffer is free: the next P panels
#pragma unroll
        for (int o = 0; o < 3; ++o)
          stage_panel(Pg[o] + nx, Mp + o * R * W, n, R, W, jx, vec);
        cp_async_commit();
      }

      if (active) {   // 2P - P MP, with P from the panel buffer
        const int j = j0 + col0;
        store_update(Bp, outg[0] + m * nn, n, W, row0, col0, j, ar, vec);
        store_update(Bp + R * W, outg[1] + m * nn, n, W, row0, col0, j, acr,
                     vec);
        store_update(Bp + 2 * R * W, outg[2] + m * nn, n, W, row0, col0, j,
                     aci, vec);
      }
    }

    // Frobenius sums over the block, in a fixed order
    const int nt = blockDim.x;
    red[t] = s_r;
    red[nt + t] = s_c;
    red[2 * nt + t] = s_i;
    __syncthreads();
    int half = 1;
    while (2 * half < nt) half <<= 1;
    for (int s = half; s > 0; s >>= 1) {
      if (t < s && t + s < nt) {
        red[t] += red[t + s];
        red[nt + t] += red[nt + t + s];
        red[2 * nt + t] += red[2 * nt + t + s];
      }
      __syncthreads();
    }
    if (t == 0) {
      const float inv_n = 1.0f / (float)n;
      const float res_r = sqrtf(red[0] * inv_n);
      const float res_c = sqrtf((red[nt] + red[2 * nt]) * inv_n);
      // a NaN on either side must reach the certificate (fmaxf drops it)
      rho_out[m] = (res_r > res_c || res_r != res_r) ? res_r : res_c;
    }
  }
}

}  // namespace

extern "C" {

// Launches on the caller's stream and returns a cudaError_t (0 on
// success); nothing synchronises. J, Pr, Pcr, Pci, the three outputs:
// (B, n, n) float32; h, rho: (B,). tx, ty, panels, threads, smem_bytes:
// the geometry of cuda_ns.geometry(n); vec_ok: n % 4 == 0 and every
// matrix 16-byte aligned.
int ns_fused_step_launch(const float* J, const float* Pr, const float* Pcr,
                         const float* Pci, const float* h, float* pr_out,
                         float* pcr_out, float* pci_out, float* rho, int B,
                         int n, int tx, int ty, int panels, int threads,
                         int smem_bytes, int vec_ok, float gamma, float mu_r,
                         float mu_i, void* stream) {
  const int R = kRM * ty, W = kCM * tx;
  if (B <= 0 || n <= 0 || tx <= 0 || ty <= 0 || R % kSlab != 0 || R < n
      || panels * W < n || threads < tx * ty || threads > kMaxThreads
      || threads % 32 != 0 || smem_bytes > kMaxSmem
      || smem_bytes < 4 * (2 * 3 * R * W + 2 * 3 * R * (kSlab + 1)
                           + 3 * threads))
    return (int)cudaErrorInvalidValue;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ns_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  // one resident block per SM slot, each walking its members
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ns_step_kernel, threads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = B < sms * per_sm ? B : sms * per_sm;
  ns_step_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      J, Pr, Pcr, Pci, h, pr_out, pcr_out, pci_out, rho, B, n, tx, ty,
      panels, vec_ok, gamma, mu_r, mu_i);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at this geometry (cudaOccupancy...), or -1.
int ns_fused_step_blocks_per_sm(int threads, int smem_bytes) {
  if (cudaFuncSetAttribute(ns_step_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem) != cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ns_step_kernel, threads, smem_bytes) != cudaSuccess)
    return -1;
  return blocks;
}

}  // extern "C"
