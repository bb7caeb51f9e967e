// Fused GroupNorm -> (FiLM) -> (SiLU) over x [N, L, C]: forward (with the
// per-group mean / rstd residual when asked, save_stats) and backward
// (below the forward).
//
// Replaces the TPU kernel diff3d_tpu/ops/pallas_film.py::_fwd_kernel
// (launched by _fwd_call, pallas_film.py:277).  Same function: f32
// per-group statistics as E[x^2] - mean^2 clamped at 0, eps 1e-5, the
// gamma/beta affine, the optional per-pixel FiLM y * (1 + scale) + shift,
// the optional SiLU, all in f32 and rounded once at the output.
//
// What bounds it on an H100: bytes.  It does ~10 flops per element and
// must read x (and scale/shift) once for the statistics and once more for
// the output; at the sampler's shapes every call is a few MB, far below
// the 295 flop/byte ridge.  Design:
//   * two passes, because a block cannot see the whole [L, C] slab of one
//     sample.  The stats pass splits L across blocks (the sampler's N is
//     only 32, one block per sample would leave most of the 132 SMs idle)
//     and writes f32 partial sums to a [2, N, G, splits] buffer; summing
//     them in a fixed order in the apply pass keeps results identical run
//     to run (no float atomics).
//   * a warp reads 32 consecutive channels of one row, so every load is
//     coalesced for any row stride; scale/shift are strided views (the two
//     halves of the FiLM Dense output, row stride 2C), never copies.
//   * the apply pass re-reads x (it is still in the 50 MB L2 at these
//     sizes) and writes the output once.
// Launch errors are returned to the caller (cudaGetLastError after each
// launch); nothing here synchronises or allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;             // lanes along channels
constexpr int TY = 8;              // rows in flight per block
constexpr int THREADS = TX * TY;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct GnArgs {
  const void* x;
  long long sxn, sxl;              // element strides of x (channel stride 1)
  const float* gamma;
  const float* beta;
  const void* scale;
  long long ssn, ssl;
  const void* shift;
  long long shn, shl;
  void* out;                       // contiguous [N, L, C]
  float* psum;                     // [N, G, splits]
  float* psq;                      // [N, G, splits]
  float* stats;                    // [2, N, G] mean, rstd, or null
  int N, L, C, G, splits, rows_per_split, rows_per_block;
  float eps;
};

// Stats pass: block (split s, sample n) sums x and x^2 over the rows
// [s * rows_per_split, ...) of every channel, folds channels to groups and
// writes the partial sums for (n, g, s).
template <typename T>
__global__ void __launch_bounds__(THREADS) gn_stats_kernel(GnArgs a) {
  extern __shared__ float4 smem_f4[];
  float* csum = reinterpret_cast<float*>(smem_f4);   // [C]
  float* csq = csum + a.C;                            // [C]
  __shared__ float red_s[TY][TX + 1];
  __shared__ float red_q[TY][TX + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int s = blockIdx.x, n = blockIdx.y;
  const int r0 = s * a.rows_per_split;
  const int r1 = min(a.L, r0 + a.rows_per_split);
  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn;

  for (int c0 = 0; c0 < a.C; c0 += TX) {
    const int c = c0 + tx;
    float sum = 0.f, sq = 0.f;
    if (c < a.C) {
      for (int r = r0 + ty; r < r1; r += TY) {
        const float v = load_f32<T>(xn + (int64_t)r * a.sxl + c);
        sum += v;
        sq += v * v;
      }
    }
    red_s[ty][tx] = sum;
    red_q[ty][tx] = sq;
    __syncthreads();
    if (ty == 0 && c < a.C) {
      float ts = 0.f, tq = 0.f;
      for (int k = 0; k < TY; ++k) {
        ts += red_s[k][tx];
        tq += red_q[k][tx];
      }
      csum[c] = ts;
      csq[c] = tq;
    }
    __syncthreads();
  }

  const int gs = a.C / a.G;
  for (int g = ty * TX + tx; g < a.G; g += THREADS) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < gs; ++k) {
      ts += csum[g * gs + k];
      tq += csq[g * gs + k];
    }
    const int64_t o = ((int64_t)n * a.G + g) * a.splits + s;
    a.psum[o] = ts;
    a.psq[o] = tq;
  }
}

// Apply pass: block (row tile, sample n) folds the partial sums of sample n
// into per-group mean / rstd (fixed order), spreads them to channels, then
// normalises, applies gamma/beta, FiLM and SiLU in f32 and writes once.
template <typename T, bool FILM, bool SILU>
__global__ void __launch_bounds__(THREADS) gn_apply_kernel(GnArgs a) {
  extern __shared__ float4 smem_f4[];
  float* gmean = reinterpret_cast<float*>(smem_f4);  // [G]
  float* grstd = gmean + a.G;                         // [G]
  float* cmean = grstd + a.G;                         // [C]
  float* crstd = cmean + a.C;                         // [C]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int n = blockIdx.y;
  const int gs = a.C / a.G;
  const float count = (float)a.L * (float)gs;

  for (int g = tid; g < a.G; g += THREADS) {
    const int64_t base = ((int64_t)n * a.G + g) * a.splits;
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < a.splits; ++k) {
      ts += a.psum[base + k];
      tq += a.psq[base + k];
    }
    const float mean = ts / count;
    const float var = fmaxf(tq / count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + a.eps);
    gmean[g] = mean;
    grstd[g] = rstd;
    if (a.stats != nullptr && blockIdx.x == 0) {
      a.stats[(int64_t)n * a.G + g] = mean;
      a.stats[((int64_t)a.N + n) * a.G + g] = rstd;
    }
  }
  __syncthreads();
  for (int c = tid; c < a.C; c += THREADS) {
    cmean[c] = gmean[c / gs];
    crstd[c] = grstd[c / gs];
  }
  __syncthreads();

  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn;
  const T* scn = static_cast<const T*>(a.scale) + (int64_t)n * a.ssn;
  const T* shn = static_cast<const T*>(a.shift) + (int64_t)n * a.shn;
  T* on = static_cast<T*>(a.out) + (int64_t)n * a.L * a.C;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.L, r0 + a.rows_per_block);
  for (int r = r0 + ty; r < r1; r += TY) {
    const T* xr = xn + (int64_t)r * a.sxl;
    T* orow = on + (int64_t)r * a.C;
    for (int c = tx; c < a.C; c += TX) {
      float y = (load_f32<T>(xr + c) - cmean[c]) * crstd[c];
      y = y * a.gamma[c] + a.beta[c];
      if (FILM) {
        const float sc = load_f32<T>(scn + (int64_t)r * a.ssl + c);
        const float sh = load_f32<T>(shn + (int64_t)r * a.shl + c);
        y = y * (1.f + sc) + sh;
      }
      if (SILU) {
        y = y * (1.f / (1.f + expf(-y)));
      }
      orow[c] = from_f32<T>(y);
    }
  }
}

template <typename T, bool FILM, bool SILU>
cudaError_t launch_apply(const GnArgs& a, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((a.L + a.rows_per_block - 1) / a.rows_per_block, a.N);
  const size_t smem = (size_t)(2 * a.G + 2 * a.C) * sizeof(float);
  gn_apply_kernel<T, FILM, SILU><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const GnArgs& a, int film, int silu,
                       cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid(a.splits, a.N);
  const size_t smem = (size_t)(2 * a.C) * sizeof(float);
  gn_stats_kernel<T><<<grid, block, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (film && silu) return launch_apply<T, true, true>(a, stream);
  if (film) return launch_apply<T, true, false>(a, stream);
  if (silu) return launch_apply<T, false, true>(a, stream);
  return launch_apply<T, false, false>(a, stream);
}

// ---------------------------------------------------------------------------
// Backward.  Replaces diff3d_tpu/ops/pallas_film.py::_bwd_kernel (launched
// by _bwd_call, pallas_film.py:414).  Same function: x_hat recomputed from
// the saved per-group mean / rstd, the upstream gradient taken back through
// SiLU (its derivative recomputed from y) and FiLM, then
//   dx     = rstd * (dxhat - mean_g(dxhat) - x_hat * mean_g(dxhat * x_hat)),
//   dscale = dy_f * y_gn,  dshift = dy_f,
//   dgamma = sum_{N,L} dy_gn * x_hat,  dbeta = sum_{N,L} dy_gn,
// every intermediate in f32; dx / dscale / dshift rounded once to the
// input dtype, dgamma / dbeta kept f32 (the parameters are f32).
//
// What bounds it on an H100: bytes, as the forward -- ~30 flops per element
// against reading x, g, scale, shift and writing dx, dscale, dshift.
// Design, the forward's shape:
//   * reduce pass, block (split s, sample n): per-channel sums of dxhat and
//     dxhat * x_hat folded to groups and written as f32 partials
//     [N, G, splits]; per-channel dgamma / dbeta partials [N, splits, C];
//   * apply pass, block (row tile, sample n): folds its sample's group
//     partials in a fixed order, recomputes the element chain and writes
//     dx, dscale, dshift once;
//   * param pass: one thread per channel folds the [N * splits] dgamma /
//     dbeta partials in a fixed order.
// No float atomics anywhere: a train step is bit-identical run to run.

struct GnBwdArgs {
  const void* x;
  long long sxn, sxl;
  const void* g;                   // upstream gradient, like x
  long long sgn, sgl;
  const float* gamma;
  const float* beta;
  const void* scale;
  long long ssn, ssl;
  const void* shift;
  long long shn, shl;
  const float* mean;               // [N, G]
  const float* rstd;               // [N, G]
  void* dx;                        // contiguous [N, L, C]
  void* dscale;                    // contiguous [N, L, C] (FiLM only)
  void* dshift;
  float* dgamma;                   // [C]
  float* dbeta;                    // [C]
  float* ps1;                      // [N, G, splits] sum dxhat
  float* ps2;                      // [N, G, splits] sum dxhat * x_hat
  float* pdg;                      // [N, splits, C]
  float* pdb;                      // [N, splits, C]
  int N, L, C, G, splits, rows_per_split, rows_per_block;
};

struct GnGrad {
  float xhat, y_gn, dy_f, dy_gn, dxhat;
};

// The element chain of one (row, channel): x, g, scale and shift are the
// row pointers, c the channel.
template <typename T, bool FILM, bool SILU>
__device__ __forceinline__ GnGrad gn_grad(const GnBwdArgs& a, const T* xr,
                                          const T* gr, const T* scr,
                                          const T* shr, int c, float mean,
                                          float rstd) {
  GnGrad o;
  const float gam = a.gamma[c];
  o.xhat = (load_f32<T>(xr + c) - mean) * rstd;
  o.y_gn = o.xhat * gam + a.beta[c];
  float sc1 = 1.f, y = o.y_gn;
  if (FILM) {
    sc1 = 1.f + load_f32<T>(scr + c);
    y = o.y_gn * sc1 + load_f32<T>(shr + c);
  }
  const float g = load_f32<T>(gr + c);
  if (SILU) {
    const float sig = 1.f / (1.f + expf(-y));
    o.dy_f = g * (sig * (1.f + y * (1.f - sig)));
  } else {
    o.dy_f = g;
  }
  o.dy_gn = FILM ? o.dy_f * sc1 : o.dy_f;
  o.dxhat = o.dy_gn * gam;
  return o;
}

template <typename T, bool FILM, bool SILU>
__global__ void __launch_bounds__(THREADS) gn_bwd_reduce_kernel(GnBwdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* c1 = reinterpret_cast<float*>(smem_f4);    // [C] sum dxhat
  float* c2 = c1 + a.C;                              // [C] sum dxhat*xhat
  __shared__ float red[4][TY][TX + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int s = blockIdx.x, n = blockIdx.y;
  const int r0 = s * a.rows_per_split;
  const int r1 = min(a.L, r0 + a.rows_per_split);
  const int gs = a.C / a.G;
  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn;
  const T* gn = static_cast<const T*>(a.g) + (int64_t)n * a.sgn;
  const T* scn = static_cast<const T*>(a.scale) + (int64_t)n * a.ssn;
  const T* shn = static_cast<const T*>(a.shift) + (int64_t)n * a.shn;

  for (int c0 = 0; c0 < a.C; c0 += TX) {
    const int c = c0 + tx;
    float s1 = 0.f, s2 = 0.f, sdg = 0.f, sdb = 0.f;
    if (c < a.C) {
      const float mean = a.mean[(int64_t)n * a.G + c / gs];
      const float rstd = a.rstd[(int64_t)n * a.G + c / gs];
      for (int r = r0 + ty; r < r1; r += TY) {
        const GnGrad o = gn_grad<T, FILM, SILU>(
            a, xn + (int64_t)r * a.sxl, gn + (int64_t)r * a.sgl,
            scn + (int64_t)r * a.ssl, shn + (int64_t)r * a.shl, c, mean,
            rstd);
        s1 += o.dxhat;
        s2 += o.dxhat * o.xhat;
        sdg += o.dy_gn * o.xhat;
        sdb += o.dy_gn;
      }
    }
    red[0][ty][tx] = s1;
    red[1][ty][tx] = s2;
    red[2][ty][tx] = sdg;
    red[3][ty][tx] = sdb;
    __syncthreads();
    if (ty == 0 && c < a.C) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < TY; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) t[q] += red[q][k][tx];
      c1[c] = t[0];
      c2[c] = t[1];
      const int64_t o = ((int64_t)n * a.splits + s) * a.C + c;
      a.pdg[o] = t[2];
      a.pdb[o] = t[3];
    }
    __syncthreads();
  }

  for (int g = ty * TX + tx; g < a.G; g += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < gs; ++k) {
      t1 += c1[g * gs + k];
      t2 += c2[g * gs + k];
    }
    const int64_t o = ((int64_t)n * a.G + g) * a.splits + s;
    a.ps1[o] = t1;
    a.ps2[o] = t2;
  }
}

template <typename T, bool FILM, bool SILU>
__global__ void __launch_bounds__(THREADS) gn_bwd_apply_kernel(GnBwdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* gm1 = reinterpret_cast<float*>(smem_f4);   // [G] mean_g(dxhat)
  float* gm2 = gm1 + a.G;                            // [G] mean_g(dxhat*xhat)
  float* gmean = gm2 + a.G;                          // [G]
  float* grstd = gmean + a.G;                        // [G]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int n = blockIdx.y;
  const int gs = a.C / a.G;
  const float count = (float)a.L * (float)gs;

  for (int g = tid; g < a.G; g += THREADS) {
    const int64_t base = ((int64_t)n * a.G + g) * a.splits;
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < a.splits; ++k) {
      t1 += a.ps1[base + k];
      t2 += a.ps2[base + k];
    }
    gm1[g] = t1 / count;
    gm2[g] = t2 / count;
    gmean[g] = a.mean[(int64_t)n * a.G + g];
    grstd[g] = a.rstd[(int64_t)n * a.G + g];
  }
  __syncthreads();

  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn;
  const T* gn = static_cast<const T*>(a.g) + (int64_t)n * a.sgn;
  const T* scn = static_cast<const T*>(a.scale) + (int64_t)n * a.ssn;
  const T* shn = static_cast<const T*>(a.shift) + (int64_t)n * a.shn;
  const int64_t on = (int64_t)n * a.L * a.C;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.L, r0 + a.rows_per_block);
  for (int r = r0 + ty; r < r1; r += TY) {
    const int64_t orow = on + (int64_t)r * a.C;
    for (int c = tx; c < a.C; c += TX) {
      const int grp = c / gs;
      const GnGrad o = gn_grad<T, FILM, SILU>(
          a, xn + (int64_t)r * a.sxl, gn + (int64_t)r * a.sgl,
          scn + (int64_t)r * a.ssl, shn + (int64_t)r * a.shl, c,
          gmean[grp], grstd[grp]);
      const float dx = grstd[grp] * (o.dxhat - gm1[grp] - o.xhat * gm2[grp]);
      static_cast<T*>(a.dx)[orow + c] = from_f32<T>(dx);
      if (FILM) {
        static_cast<T*>(a.dscale)[orow + c] = from_f32<T>(o.dy_f * o.y_gn);
        static_cast<T*>(a.dshift)[orow + c] = from_f32<T>(o.dy_f);
      }
    }
  }
}

__global__ void gn_bwd_param_kernel(GnBwdArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  float dg = 0.f, db = 0.f;
  const int rows = a.N * a.splits;
  for (int k = 0; k < rows; ++k) {
    dg += a.pdg[(int64_t)k * a.C + c];
    db += a.pdb[(int64_t)k * a.C + c];
  }
  a.dgamma[c] = dg;
  a.dbeta[c] = db;
}

template <typename T, bool FILM, bool SILU>
cudaError_t launch_bwd(const GnBwdArgs& a, cudaStream_t stream) {
  const dim3 block(TX, TY);
  gn_bwd_reduce_kernel<T, FILM, SILU>
      <<<dim3(a.splits, a.N), block, (size_t)(2 * a.C) * sizeof(float),
         stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_apply_kernel<T, FILM, SILU>
      <<<dim3((a.L + a.rows_per_block - 1) / a.rows_per_block, a.N), block,
         (size_t)(4 * a.G) * sizeof(float), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_param_kernel<<<(a.C + THREADS - 1) / THREADS, THREADS, 0,
                        stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_all(const GnBwdArgs& a, int film, int silu,
                           cudaStream_t stream) {
  if (film && silu) return launch_bwd<T, true, true>(a, stream);
  if (film) return launch_bwd<T, true, false>(a, stream);
  if (silu) return launch_bwd<T, false, true>(a, stream);
  return launch_bwd<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, scale, shift and out share it).
// partial: float [2, N, G, splits] scratch.  stats: float [2, N, G]
// (per-group mean, then rstd) written when not null -- the residual of
// the backward (save_stats).  Returns a cudaError_t code.
int gn_fused_forward(const void* x, long long sxn, long long sxl,
                     const void* gamma, const void* beta,
                     const void* scale, long long ssn, long long ssl,
                     const void* shift, long long shn, long long shl,
                     void* out, void* partial, void* stats, int N, int L,
                     int C, int G,
                     int splits, int rows_per_split, int rows_per_block,
                     int dtype, int film, int silu, float eps,
                     void* stream) {
  if (N < 1 || L < 1 || C < 1 || G < 1 || C % G != 0 || splits < 1 ||
      rows_per_split < 1 || rows_per_block < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  GnArgs a;
  a.x = x;
  a.sxn = sxn;
  a.sxl = sxl;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.scale = film ? scale : x;
  a.ssn = ssn;
  a.ssl = ssl;
  a.shift = film ? shift : x;
  a.shn = shn;
  a.shl = shl;
  a.out = out;
  a.psum = static_cast<float*>(partial);
  a.psq = a.psum + (size_t)N * G * splits;
  a.stats = static_cast<float*>(stats);
  a.N = N;
  a.L = L;
  a.C = C;
  a.G = G;
  a.splits = splits;
  a.rows_per_split = rows_per_split;
  a.rows_per_block = rows_per_block;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
                        ? launch_all<float>(a, film, silu, st)
                        : launch_all<__nv_bfloat16>(a, film, silu, st);
  return (int)err;
}

// Backward of gn_fused_forward.  stats: the forward's float [2, N, G]
// (mean, rstd).  dx (and dscale / dshift with FiLM) are contiguous
// [N, L, C] of dtype; dgamma / dbeta float [C].  partial: float scratch of
// 2 * N * G * splits + 2 * N * splits * C.  Returns a cudaError_t code.
int gn_fused_backward(const void* x, long long sxn, long long sxl,
                      const void* g, long long sgn, long long sgl,
                      const void* gamma, const void* beta,
                      const void* scale, long long ssn, long long ssl,
                      const void* shift, long long shn, long long shl,
                      const void* stats, void* dx, void* dscale,
                      void* dshift, void* dgamma, void* dbeta,
                      void* partial, int N, int L, int C, int G, int splits,
                      int rows_per_split, int rows_per_block, int dtype,
                      int film, int silu, void* stream) {
  if (N < 1 || L < 1 || C < 1 || G < 1 || C % G != 0 || splits < 1 ||
      rows_per_split < 1 || rows_per_block < 1 || (dtype != 0 && dtype != 1)
      || stats == nullptr || (film && (dscale == nullptr || dshift == nullptr)))
    return (int)cudaErrorInvalidValue;
  GnBwdArgs a;
  a.x = x;
  a.sxn = sxn;
  a.sxl = sxl;
  a.g = g;
  a.sgn = sgn;
  a.sgl = sgl;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.scale = film ? scale : x;
  a.ssn = film ? ssn : sxn;
  a.ssl = film ? ssl : sxl;
  a.shift = film ? shift : x;
  a.shn = film ? shn : sxn;
  a.shl = film ? shl : sxl;
  a.mean = static_cast<const float*>(stats);
  a.rstd = a.mean + (size_t)N * G;
  a.dx = dx;
  a.dscale = dscale;
  a.dshift = dshift;
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.ps1 = static_cast<float*>(partial);
  a.ps2 = a.ps1 + (size_t)N * G * splits;
  a.pdg = a.ps2 + (size_t)N * G * splits;
  a.pdb = a.pdg + (size_t)N * splits * C;
  a.N = N;
  a.L = L;
  a.C = C;
  a.G = G;
  a.splits = splits;
  a.rows_per_split = rows_per_split;
  a.rows_per_block = rows_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
                        ? launch_bwd_all<float>(a, film, silu, st)
                        : launch_bwd_all<__nv_bfloat16>(a, film, silu, st);
  return (int)err;
}

const char* gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
