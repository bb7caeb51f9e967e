// Flash attention, forward, over q [B, Lq, H, D], k/v [B, Lk, H, D].
//
// Replaces the TPU kernel diff3d_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by _fwd_call, pallas_attention.py:185, with save_lse=False).
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Returns a cudaError_t code.
int flash_attention_forward(const void* q, long long sqb, long long sql,
                            long long sqh, const void* k, long long skb,
                            long long skl, long long skh, const void* v,
                            long long svb, long long svl, long long svh,
                            void* o, long long sob, long long sol,
                            long long soh, int B, int H, int Lq, int Lk,
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

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
