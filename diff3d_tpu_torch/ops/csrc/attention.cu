// Flash attention over q [B, Lq, H, D], k/v [B, Lk, H, D]: forward (with
// the per-row log-sum-exp when asked, save_lse) and backward (below the
// forward).
//
// Replaces the TPU kernel diff3d_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by _fwd_call, pallas_attention.py:185, with save_lse=False and,
// when the lse pointer is given, save_lse=True: lse = m + log(l)).
// Same function: softmax(q k^T / sqrt(D)) v with an online softmax over
// key tiles (running max, sum and accumulator in f32), padded key columns
// masked to -1e30, and l == 0 -> 1 at the end (pallas_attention.py:157).
//
// What bounds it on an H100: operations.  At the sampler's shapes (L = 256,
// D = 64 and L = 64, D = 128) a call does 4 * L^2 * D flops per (b, h)
// against 4 * L * D elements of I/O, i.e. L flops per byte in f32 I/O and
// 2L in bf16 -- above the ridge of the f32 CUDA cores this kernel uses.
// This first version computes on the CUDA cores in f32 (no tensor cores),
// which keeps it exact against the f32 plain version; mma/wgmma tiles are
// later work.  Design:
//   * one block per (b * h, 32-query tile), 256 threads; the q tile and
//     64-key k/v tiles are staged in shared memory as f32 (rows padded by
//     one float so the key-major score loads are free of bank conflicts);
//   * q/k/v are strided views of the projection outputs (head stride D,
//     row stride C): no permute copies, the kernel computes its offsets;
//   * the [Lq, Lk] scores never leave shared memory.
// The head dim is padded to DCH * 32 (DCH = 1..8, D <= 256), a template
// parameter so the per-thread accumulators stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int NT = 256;             // threads per block
constexpr float NEG_INF = -1e30f;

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

struct FlashArgs {
  const void* q;
  long long sqb, sql, sqh;         // element strides (head-dim stride 1)
  const void* k;
  long long skb, skl, skh;
  const void* v;
  long long svb, svl, svh;
  void* o;
  long long sob, sol, soh;
  float* lse;                      // [B, H, Lq] f32, or null
  int B, H, Lq, Lk, D;
  float scale;
};

template <int DCH>
constexpr size_t smem_floats() {
  return (size_t)(BQ + 2 * BK) * (DCH * 32 + 1) + BQ * BK + 3 * BQ;
}

template <typename T, int DCH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs a) {
  constexpr int DP = DCH * 32;      // padded head dim
  constexpr int LD = DP + 1;        // shared row stride
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);    // [BQ][LD]
  float* Ks = Qs + BQ * LD;                          // [BK][LD]
  float* Vs = Ks + BK * LD;                          // [BK][LD]
  float* S = Vs + BK * LD;                           // [BQ][BK]
  float* m_s = S + BQ * BK;                          // [BQ] running max
  float* l_s = m_s + BQ;                             // [BQ] running sum
  float* a_s = l_s + BQ;                             // [BQ] tile rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = static_cast<const T*>(a.q) + (int64_t)b * a.sqb +
                (int64_t)h * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.skb +
                (int64_t)h * a.skh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.svb +
                (int64_t)h * a.svh;

  for (int e = tid; e < BQ * DP; e += NT) {
    const int i = e / DP, d = e % DP;
    float val = 0.f;
    if (q0 + i < a.Lq && d < a.D)
      val = load_f32<T>(qb + (int64_t)(q0 + i) * a.sql + d);
    Qs[i * LD + d] = val;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // Scores: thread (sj, si0) computes rows si0 + 4r (r < 8) of key sj.
  const int sj = tid % BK, si0 = tid / BK;
  // Output: thread (lane, warp) holds rows warp + 8r (r < 4) and head
  // columns lane + 32c (c < DCH).
  float acc[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < a.Lk; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/S are no longer read
    for (int e = tid; e < BK * DP; e += NT) {
      const int j = e / DP, d = e % DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < a.Lk && d < a.D) {
        kv = load_f32<T>(kb + (int64_t)(k0 + j) * a.skl + d);
        vv = load_f32<T>(vb + (int64_t)(k0 + j) * a.svl + d);
      }
      Ks[j * LD + d] = kv;
      Vs[j * LD + d] = vv;
    }
    __syncthreads();

    float sacc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) sacc[r] = 0.f;
    for (int d = 0; d < DP; ++d) {
      const float kd = Ks[sj * LD + d];
#pragma unroll
      for (int r = 0; r < 8; ++r) sacc[r] += Qs[(si0 + 4 * r) * LD + d] * kd;
    }
    const bool valid = k0 + sj < a.Lk;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      S[(si0 + 4 * r) * BK + sj] = valid ? sacc[r] * a.scale : NEG_INF;
    __syncthreads();

    // Online softmax: warp w owns rows 4w .. 4w + 3.
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int i = warp * 4 + rr;
      const float s0 = S[i * BK + lane], s1 = S[i * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      S[i * BK + lane] = p0;
      S[i * BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = alpha * l_s[i] + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = a_s[warp + 8 * r];
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      float vj[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) vj[c] = Vs[j * LD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = S[(warp + 8 * r) * BK + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[r][c] += p * vj[c];
      }
    }
  }

  T* ob = static_cast<T*>(a.o) + (int64_t)b * a.sob + (int64_t)h * a.soh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = warp + 8 * r;
    if (q0 + i >= a.Lq) continue;
    const float l = l_s[i];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D)
        ob[(int64_t)(q0 + i) * a.sol + d] = from_f32<T>(acc[r][c] / l_safe);
    }
    if (a.lse != nullptr && lane == 0)
      a.lse[(int64_t)blockIdx.y * a.Lq + q0 + i] = m_s[i] + logf(l_safe);
  }
}

template <typename T, int DCH>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DCH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_kernel<T, DCH><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FlashArgs& a, cudaStream_t stream) {
  switch ((a.D + 31) / 32) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward.  Replaces diff3d_tpu/ops/pallas_attention.py::_bwd_dkdv_kernel
// (the `dkdv` call, :287) and ::_bwd_dq_kernel (the `dq` call, :306).  Same
// function: with P = exp(q k^T * scale - lse) recomputed per tile,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta + glse) * scale,
//   dK = dS^T Q,  dQ = dS K,
// where delta = rowsum(dO * O) and glse is the lse cotangent (zero on the
// training path).  Accumulation in f32; dq / dk / dv rounded once.
//
// What bounds it on an H100: operations (10 * L^2 * D per (b, h) against
// ~8 * L * D elements of I/O), like the forward; this first version also
// runs on the f32 CUDA cores.  Design:
//   * delta is computed once, in a pre-pass (one warp per query row), as
//     rowsum(dO * O) - glse into a [B, H, Lq] f32 scratch, so the two main
//     kernels read one number per row instead of re-reducing dO * O;
//   * the Pallas two-kernel split is kept so neither kernel needs atomics:
//     dK/dV, one block per 32-key tile looping over 32-query tiles; dQ, one
//     block per 32-query tile looping over 32-key tiles;
//   * Q, dO, K, V tiles staged in shared memory as f32 with rows padded by
//     one float (conflict-free key-major reads); the 32 x 32 P and dS tiles
//     never leave shared memory.  At D = 256 a block holds 4 x 32 x 257 + 2 x
//     32 x 33 floats = 140 KB, inside the 227 KB a block may use.

constexpr int BB = 32;              // rows of a backward tile (keys or queries)

struct FlashBwdArgs {
  const void* q;
  long long sqb, sql, sqh;
  const void* k;
  long long skb, skl, skh;
  const void* v;
  long long svb, svl, svh;
  const void* o;
  long long sob, sol, soh;
  const void* dO;
  long long sdb, sdl, sdh;
  const float* lse;                // [B, H, Lq]
  const float* glse;               // [B, H, Lq] or null (zero)
  float* delta;                    // [B, H, Lq] scratch
  void* dq;                        // contiguous [B, Lq, H, D]
  void* dk;                        // contiguous [B, Lk, H, D]
  void* dv;
  int B, H, Lq, Lk, D;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(FlashBwdArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (NT / 32) + warp;
  if (i >= a.Lq) return;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const T* orow = static_cast<const T*>(a.o) + (int64_t)b * a.sob +
                  (int64_t)h * a.soh + (int64_t)i * a.sol;
  const T* drow = static_cast<const T*>(a.dO) + (int64_t)b * a.sdb +
                  (int64_t)h * a.sdh + (int64_t)i * a.sdl;
  float sum = 0.f;
  for (int d = lane; d < a.D; d += 32)
    sum += load_f32<T>(orow + d) * load_f32<T>(drow + d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int64_t r = (int64_t)blockIdx.y * a.Lq + i;
    a.delta[r] = sum - (a.glse != nullptr ? a.glse[r] : 0.f);
  }
}

template <int DCH>
constexpr size_t bwd_smem_floats() {
  return (size_t)4 * BB * (DCH * 32 + 1) + 2 * BB * (BB + 1) + 2 * BB;
}

// Stage rows [r0, r0 + BB) of a strided [L, D] head view as f32 (zeros past
// L and D).
template <typename T, int DCH>
__device__ __forceinline__ void stage(float* dst, const T* src, long long sl,
                                      int r0, int L, int D) {
  constexpr int DP = DCH * 32, LD = DP + 1;
  for (int e = threadIdx.x; e < BB * DP; e += NT) {
    const int i = e / DP, d = e % DP;
    float val = 0.f;
    if (r0 + i < L && d < D) val = load_f32<T>(src + (int64_t)(r0 + i) * sl + d);
    dst[i * LD + d] = val;
  }
}

// P and dS of one (query tile, key tile) pair into shared memory:
// thread (lane j, warp w) computes rows w + 8r (r < 4) of key column j.
template <int DCH>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s,
                                           const float* dl_s, float* P,
                                           float* dS, int nq, int nk,
                                           float scale) {
  constexpr int LD = DCH * 32 + 1;
  const int j = threadIdx.x & 31, w = threadIdx.x >> 5;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < DCH * 32; ++d) {
    const float kd = Ks[j * LD + d], vd = Vs[j * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[r] += Qs[(w + 8 * r) * LD + d] * kd;
      dp[r] += dOs[(w + 8 * r) * LD + d] * vd;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = w + 8 * r;
    const float p = (i < nq && j < nk) ? expf(s[r] * scale - lse_s[i]) : 0.f;
    P[i * (BB + 1) + j] = p;
    dS[i * (BB + 1) + j] = p * (dp[r] - dl_s[i]) * scale;
  }
}

template <typename T, int DCH>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(FlashBwdArgs a) {
  constexpr int DP = DCH * 32, LD = DP + 1;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);    // [BB][LD]
  float* Vs = Ks + BB * LD;
  float* Qs = Vs + BB * LD;
  float* dOs = Qs + BB * LD;
  float* P = dOs + BB * LD;                          // [BB][BB + 1]
  float* dS = P + BB * (BB + 1);
  float* lse_s = dS + BB * (BB + 1);                 // [BB]
  float* dl_s = lse_s + BB;                          // [BB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BB;
  const T* qb = static_cast<const T*>(a.q) + (int64_t)b * a.sqb +
                (int64_t)h * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.skb +
                (int64_t)h * a.skh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.svb +
                (int64_t)h * a.svh;
  const T* db = static_cast<const T*>(a.dO) + (int64_t)b * a.sdb +
                (int64_t)h * a.sdh;
  stage<T, DCH>(Ks, kb, a.skl, k0, a.Lk, a.D);
  stage<T, DCH>(Vs, vb, a.svl, k0, a.Lk, a.D);

  // Thread (lane, warp) accumulates key rows warp + 8r, head columns
  // lane + 32c.
  float dk[4][DCH], dv[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int q0 = 0; q0 < a.Lq; q0 += BB) {
    __syncthreads();  // the previous tile's Q / dO / P / dS are read
    stage<T, DCH>(Qs, qb, a.sql, q0, a.Lq, a.D);
    stage<T, DCH>(dOs, db, a.sdl, q0, a.Lq, a.D);
    if (tid < BB) {
      const bool ok = q0 + tid < a.Lq;
      const int64_t r = (int64_t)bh * a.Lq + q0 + tid;
      lse_s[tid] = ok ? a.lse[r] : 0.f;
      dl_s[tid] = ok ? a.delta[r] : 0.f;
    }
    __syncthreads();
    score_tile<DCH>(Qs, dOs, Ks, Vs, lse_s, dl_s, P, dS, a.Lq - q0,
                    a.Lk - k0, a.scale);
    __syncthreads();
    for (int i = 0; i < BB; ++i) {
      float qi[DCH], di[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        qi[c] = Qs[i * LD + lane + 32 * c];
        di[c] = dOs[i * LD + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = P[i * (BB + 1) + warp + 8 * r];
        const float ds = dS[i * (BB + 1) + warp + 8 * r];
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          dv[r][c] += p * di[c];
          dk[r][c] += ds * qi[c];
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + warp + 8 * r;
    if (j >= a.Lk) continue;
    const int64_t row = (((int64_t)b * a.Lk + j) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D) {
        dkb[row + d] = from_f32<T>(dk[r][c]);
        dvb[row + d] = from_f32<T>(dv[r][c]);
      }
    }
  }
}

template <typename T, int DCH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(FlashBwdArgs a) {
  constexpr int DP = DCH * 32, LD = DP + 1;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);    // [BB][LD]
  float* dOs = Qs + BB * LD;
  float* Ks = dOs + BB * LD;
  float* Vs = Ks + BB * LD;
  float* P = Vs + BB * LD;                           // [BB][BB + 1]
  float* dS = P + BB * (BB + 1);
  float* lse_s = dS + BB * (BB + 1);
  float* dl_s = lse_s + BB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BB;
  const T* qb = static_cast<const T*>(a.q) + (int64_t)b * a.sqb +
                (int64_t)h * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.skb +
                (int64_t)h * a.skh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.svb +
                (int64_t)h * a.svh;
  const T* db = static_cast<const T*>(a.dO) + (int64_t)b * a.sdb +
                (int64_t)h * a.sdh;
  stage<T, DCH>(Qs, qb, a.sql, q0, a.Lq, a.D);
  stage<T, DCH>(dOs, db, a.sdl, q0, a.Lq, a.D);
  if (tid < BB) {
    const bool ok = q0 + tid < a.Lq;
    const int64_t r = (int64_t)bh * a.Lq + q0 + tid;
    lse_s[tid] = ok ? a.lse[r] : 0.f;
    dl_s[tid] = ok ? a.delta[r] : 0.f;
  }

  // Thread (lane, warp) accumulates query rows warp + 8r, columns
  // lane + 32c.
  float dq[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) dq[r][c] = 0.f;

  for (int k0 = 0; k0 < a.Lk; k0 += BB) {
    __syncthreads();  // the previous tile's K / V / dS are read
    stage<T, DCH>(Ks, kb, a.skl, k0, a.Lk, a.D);
    stage<T, DCH>(Vs, vb, a.svl, k0, a.Lk, a.D);
    __syncthreads();
    score_tile<DCH>(Qs, dOs, Ks, Vs, lse_s, dl_s, P, dS, a.Lq - q0,
                    a.Lk - k0, a.scale);
    __syncthreads();
    for (int j = 0; j < BB; ++j) {
      float kj[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) kj[c] = Ks[j * LD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dS[(warp + 8 * r) * (BB + 1) + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) dq[r][c] += ds * kj[c];
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + warp + 8 * r;
    if (i >= a.Lq) continue;
    const int64_t row = (((int64_t)b * a.Lq + i) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D) dqb[row + d] = from_f32<T>(dq[r][c]);
    }
  }
}

template <typename T, int DCH>
cudaError_t launch_bwd(const FlashBwdArgs& a, int part, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<DCH>() * sizeof(float);
  if (part == 0) {
    flash_bwd_delta_kernel<T>
        <<<dim3((a.Lq + NT / 32 - 1) / (NT / 32), a.B * a.H), NT, 0,
           stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, DCH>
        <<<dim3((a.Lk + BB - 1) / BB, a.B * a.H), NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DCH>
      <<<dim3((a.Lq + BB - 1) / BB, a.B * a.H), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_d(const FlashBwdArgs& a, int part,
                         cudaStream_t stream) {
  switch ((a.D + 31) / 32) {
    case 1: return launch_bwd<T, 1>(a, part, stream);
    case 2: return launch_bwd<T, 2>(a, part, stream);
    case 3: return launch_bwd<T, 3>(a, part, stream);
    case 4: return launch_bwd<T, 4>(a, part, stream);
    case 5: return launch_bwd<T, 5>(a, part, stream);
    case 6: return launch_bwd<T, 6>(a, part, stream);
    case 7: return launch_bwd<T, 7>(a, part, stream);
    case 8: return launch_bwd<T, 8>(a, part, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  lse:
// float [B, H, Lq], the per-row log-sum-exp, written when not null
// (save_lse).  Returns a cudaError_t code.
int flash_attention_forward(const void* q, long long sqb, long long sql,
                            long long sqh, const void* k, long long skb,
                            long long skl, long long skh, const void* v,
                            long long svb, long long svl, long long svh,
                            void* o, long long sob, long long sol,
                            long long soh, void* lse, int B, int H, int Lq,
                            int Lk,
                            int D, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > 256 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q;
  a.sqb = sqb;
  a.sql = sql;
  a.sqh = sqh;
  a.k = k;
  a.skb = skb;
  a.skl = skl;
  a.skh = skh;
  a.v = v;
  a.svb = svb;
  a.svl = svl;
  a.svh = svh;
  a.o = o;
  a.sob = sob;
  a.sol = sol;
  a.soh = soh;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_d<float>(a, st)
                               : launch_d<__nv_bfloat16>(a, st);
  return (int)err;
}

// Backward of flash_attention_forward (saved with lse).  part 0 runs the
// delta pre-pass (into `delta`, float [B, H, Lq]) and the dK/dV kernel;
// part 1 the dQ kernel, which reads that delta.  glse may be null (zero).
// dq / dk / dv are contiguous [B, L, H, D] of dtype.  Returns a
// cudaError_t code.
int flash_attention_backward(
    const void* q, long long sqb, long long sql, long long sqh,
    const void* k, long long skb, long long skl, long long skh,
    const void* v, long long svb, long long svl, long long svh,
    const void* o, long long sob, long long sol, long long soh,
    const void* dO, long long sdb, long long sdl, long long sdh,
    const void* lse, const void* glse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Lq, int Lk, int D, float scale, int dtype,
    int part, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > 256 ||
      (dtype != 0 && dtype != 1) || (part != 0 && part != 1) ||
      lse == nullptr || delta == nullptr ||
      (part == 0 && (dk == nullptr || dv == nullptr)) ||
      (part == 1 && dq == nullptr))
    return (int)cudaErrorInvalidValue;
  FlashBwdArgs a;
  a.q = q;
  a.sqb = sqb;
  a.sql = sql;
  a.sqh = sqh;
  a.k = k;
  a.skb = skb;
  a.skl = skl;
  a.skh = skh;
  a.v = v;
  a.svb = svb;
  a.svl = svl;
  a.svh = svh;
  a.o = o;
  a.sob = sob;
  a.sol = sol;
  a.soh = soh;
  a.dO = dO;
  a.sdb = sdb;
  a.sdl = sdl;
  a.sdh = sdh;
  a.lse = static_cast<const float*>(lse);
  a.glse = static_cast<const float*>(glse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_bwd_d<float>(a, part, st)
                               : launch_bwd_d<__nv_bfloat16>(a, part, st);
  return (int)err;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
