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
// What bounds it on an H100.  Per (b, h) a call does 4 * L^2 * D flops
// against 4 * L * D elements of I/O (q, k, v in, o out): L/2 flops per
// byte in bf16, L/4 in f32.  On the bf16 tensor cores the ridge is ~295
// flops per byte, so the bf16 forward is bound by bytes at srn64's L <= 256
// and by operations only from L ~ 590 (srn128's L = 1024).  The f32 path
// runs on the f32 CUDA cores (67 TFLOP/s), whose ridge it is above.
//
// Two designs, one per dtype:
//   * bf16 (flash_fwd_mma_kernel, below): tensor cores.  One CTA of 4 warps
//     per (b * h, 64-query tile), each warp 16 query rows.  K/V tiles of BK
//     keys (64 at D <= 128, 32 at D = 256) come in with 16-byte cp.async
//     into bf16 shared memory (rows padded by 16 bytes: conflict-free
//     ldmatrix), two stages, so the next tile loads while this one
//     computes.  S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products
//     with f32 accumulators; the online softmax stays in registers (row max
//     and sum reduced across each lane quad, exp2 with a log2(e) prescale).
//     Q fragments stay in registers for the key loop at D <= 128 and are
//     re-read by ldmatrix at D = 256.  Numerics: the Pallas kernel keeps P
//     in f32 for P V (pallas_attention.py:144-148).  Here P goes into P V
//     as three bf16 fragments whose sum is the f32 P (three mma per P V
//     step instead of one): one bf16 P (~2^-9 relative per term) met the
//     kernel checks but moved a small bf16 model's gradients 0.110
//     (relative L2) from the plain path's, past the card test's 0.1.  The
//     row sum l is taken over the f32 P, as FlashAttention-2 does.
//   * f32 (flash_fwd_kernel): the f32 CUDA cores, exact against the f32
//     plain version (TF32 would not be).  One block per (b * h, 32-query
//     tile), 256 threads; q and 64-key k/v tiles staged in shared memory as
//     f32 (rows padded by one float); the [Lq, Lk] scores never leave
//     shared memory.  Head dim padded to DCH * 32 (DCH = 1..8).
//   * 256 < D <= 512, both dtypes: the same CUDA-core kernel with the head
//     dim padded to 384 or 512 (DCH = 12, 16) and 32-key tiles, so q and
//     the k/v tiles (201 KB at D = 512) fit a block.  No configuration of
//     the repo uses these head dims; they are the Pallas kernel's domain
//     (pallas_attention.py:52), taken by the simplest kernel that is right.
// All read q/k/v as strided views of the projection outputs (head stride
// D, row stride C), with no permute copies, and take D <= 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int NT = 256;             // threads per block
constexpr int MAX_D = 512;          // the Pallas kernel's head-dim cap
constexpr float NEG_INF = -1e30f;

// Keys per tile of the CUDA-core forward: 64 up to D = 256, 32 above
// (DCH > 8), so q and two k/v tiles of 512 f32 columns fit the 227 KB a
// block may use.
template <int DCH>
__host__ __device__ constexpr int fwd_bk() {
  return DCH <= 8 ? 64 : 32;
}

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
  int vec_in, vec_out;             // 16-byte paths (bf16 kernel only)
};

template <int DCH>
constexpr size_t smem_floats() {
  constexpr int BK = fwd_bk<DCH>();
  return (size_t)(BQ + 2 * BK) * (DCH * 32 + 1) + BQ * BK + 3 * BQ;
}

// The CUDA-core forward: f32 in both dtypes at D > 256, f32 at any D.
template <typename T, int DCH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs a) {
  constexpr int BK = fwd_bk<DCH>();
  constexpr int DP = DCH * 32;      // padded head dim
  constexpr int LD = DP + 1;        // shared row stride
  constexpr int RS = NT / BK;       // score rows a thread steps by
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

  // Scores: thread (sj, si0) computes rows si0 + RS r (r < BQ / RS) of
  // key sj.
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

    float sacc[BQ / RS];
#pragma unroll
    for (int r = 0; r < BQ / RS; ++r) sacc[r] = 0.f;
    for (int d = 0; d < DP; ++d) {
      const float kd = Ks[sj * LD + d];
#pragma unroll
      for (int r = 0; r < BQ / RS; ++r)
        sacc[r] += Qs[(si0 + RS * r) * LD + d] * kd;
    }
    const bool valid = k0 + sj < a.Lk;
#pragma unroll
    for (int r = 0; r < BQ / RS; ++r)
      S[(si0 + RS * r) * BK + sj] = valid ? sacc[r] * a.scale : NEG_INF;
    __syncthreads();

    // Online softmax: warp w owns rows 4w .. 4w + 3; lane reads keys
    // lane + 32u.
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int i = warp * 4 + rr;
      float sv[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        sv[u] = S[i * BK + lane + 32 * u];
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(sv[u] - m_new);
        S[i * BK + lane + 32 * u] = p;
        sum += p;
      }
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

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (each launcher keeps its own `done` bits): the attribute persists, and
// setting it costs a CUDA runtime call on every launch otherwise.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

template <typename T, int DCH>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DCH>() * sizeof(float);
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DCH>, smem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_kernel<T, DCH><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// Above D = 256 both dtypes take the CUDA-core kernels with the head dim
// padded to 384 or 512: two instantiations instead of eight.
template <typename T>
cudaError_t launch_wide(const FlashArgs& a, cudaStream_t stream) {
  if (a.D <= 384) return launch<T, 12>(a, stream);
  if (a.D <= 512) return launch<T, 16>(a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const FlashArgs& a, cudaStream_t stream) {
  switch ((a.D + 31) / 32) {
    case 1: return launch<float, 1>(a, stream);
    case 2: return launch<float, 2>(a, stream);
    case 3: return launch<float, 3>(a, stream);
    case 4: return launch<float, 4>(a, stream);
    case 5: return launch<float, 5>(a, stream);
    case 6: return launch<float, 6>(a, stream);
    case 7: return launch<float, 7>(a, stream);
    case 8: return launch<float, 8>(a, stream);
    default: return launch_wide<float>(a, stream);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks (bf16 in, f32 accumulate), as inline PTX.
// Fragment layouts of mma.m16n8k16, lane = 4 * g + t: A (16 x 16, row
// major) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
// a3 = (g + 8, 2t + 8..); B (16 x 8) b0 = (2t..2t+1, g), b1 = (2t + 8.., g);
// C (16 x 8) c0, c1 = (g, 2t), (g, 2t + 1), c2, c3 = (g + 8, 2t), (g + 8,
// 2t + 1).  So the C fragments of two adjacent n-tiles, packed to bf16, are
// the A fragment of the next product over those 16 columns.

typedef __nv_bfloat16 bf16;
constexpr int MMA_NT = 128;         // 4 warps
constexpr int BM = 64;              // rows a CTA owns: 16 per warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane i gives the shared address of row i % 8 of
// matrix i / 8 and receives (row g, cols 2t..2t+1) of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same, transposed: lane receives (rows 2t..2t+1, col g) of each.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a * b over one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Register r of three A fragments whose sum is (x, y) to f32 precision:
// each part keeps the next 8 significant bits of what the ones before left.
__device__ __forceinline__ void split3_bf16(float x, float y,
                                            uint32_t (&parts)[3][4], int r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    parts[i][r] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __bfloat162float(h.x);
    y -= __bfloat162float(h.y);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + ROWS) of a strided [L, D] bf16 head view into a shared
// [ROWS][DP + 8] tile, zeros past L and D.  vec: 16-byte cp.async (the
// caller commits and waits); otherwise element by element.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long sl, int r0, int L, int D,
                                          bool vec) {
  constexpr int LDS = DP + 8, CH = DP / 8;
  if (vec) {
    const uint32_t sdst = smem_u32(dst);
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * CH; e += MMA_NT) {
      const int i = e / CH, c = e % CH;
      const bool ok = r0 + i < L && c * 8 < D;
      cp_async16(sdst + (i * LDS + c * 8) * 2,
                 ok ? src + (int64_t)(r0 + i) * sl + c * 8 : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += MMA_NT) {
      const int i = e / DP, d = e % DP;
      bf16 val = __float2bfloat16_rn(0.f);
      if (r0 + i < L && d < D) val = src[(int64_t)(r0 + i) * sl + d];
      dst[i * LDS + d] = val;
    }
  }
}

// A warp's 16 rows of DW columns of a shared tile (row stride lds) out to
// a strided [L, D] view: 16-byte stores when vec, else element by element.
template <int DW>
__device__ __forceinline__ void store_rows(bf16* dst, long long sl,
                                           const bf16* tile, int r0, int L,
                                           int D, bool vec, int lds) {
  constexpr int CH = DW / 8;
  const int lane = threadIdx.x & 31;
  if (vec) {
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int i = e / CH, c = e % CH;
      if (r0 + i < L && c * 8 < D)
        *reinterpret_cast<uint4*>(dst + (int64_t)(r0 + i) * sl + c * 8) =
            *reinterpret_cast<const uint4*>(tile + i * lds + c * 8);
    }
  } else {
    for (int e = lane; e < 16 * DW; e += 32) {
      const int i = e / DW, d = e % DW;
      if (r0 + i < L && d < D)
        dst[(int64_t)(r0 + i) * sl + d] = tile[i * lds + d];
    }
  }
}

// Per-lane ldmatrix byte offsets inside a 16 x 16 block of a tile with
// row stride LDS elements.  A operand (and the transposed B operand):
// matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
// B operand read as stored ([n][k]): (0-7, 0-7), (0-7, 8-15), (8-15, 0-7),
// (8-15, 8-15), i.e. b0, b1 of n-tile 0 then of n-tile 1.
template <int LDS>
__device__ __forceinline__ uint32_t a_off(int lane) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8) * 2;
}
template <int LDS>
__device__ __forceinline__ uint32_t b_off(int lane) {
  return (((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8) * 2;
}

// The bf16 forward.  Replaces diff3d_tpu/ops/pallas_attention.py::
// _fwd_kernel (pallas_attention.py:119-161, launched at :185) for bf16
// operands; design in the note at the top of this file.
template <int DP>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_mma_kernel(FlashArgs a) {
  constexpr int BK = DP <= 128 ? 64 : 32;   // keys per tile
  constexpr int LDS = DP + 8;               // shared row stride (elements)
  constexpr int KC = DP / 16;               // k-chunks of Q K^T
  constexpr int NS = BK / 8;                // n-tiles of S
  constexpr int NO = DP / 8;                // n-tiles of O
  constexpr bool Q_REGS = DP <= 128;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);  // [BM][LDS]
  bf16* Ks = Qs + BM * LDS;                      // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                  // [2][BK][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = static_cast<const bf16*>(a.q) + (int64_t)b * a.sqb +
                   (int64_t)h * a.sqh;
  const bf16* kb = static_cast<const bf16*>(a.k) + (int64_t)b * a.skb +
                   (int64_t)h * a.skh;
  const bf16* vb = static_cast<const bf16*>(a.v) + (int64_t)b * a.svb +
                   (int64_t)h * a.svh;
  const bool vec = a.vec_in != 0;
  const int nk = (a.Lk + BK - 1) / BK;

  load_tile<BM, DP>(Qs, qb, a.sql, q0, a.Lq, a.D, vec);
  load_tile<BK, DP>(Ks, kb, a.skl, 0, a.Lk, a.D, vec);
  load_tile<BK, DP>(Vs, vb, a.svl, 0, a.Lk, a.D, vec);
  cp_async_commit();

  // Shared byte addresses of this lane's ldmatrix rows: the warp's 16 query
  // rows (A), stage 0 of K (B as stored) and of V (B transposed).
  const uint32_t qA = smem_u32(Qs) + warp * 16 * LDS * 2 + a_off<LDS>(lane);
  const uint32_t kB = smem_u32(Ks) + b_off<LDS>(lane);
  const uint32_t vA = smem_u32(Vs) + a_off<LDS>(lane);
  uint32_t qf[Q_REGS ? KC : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Rows g and g + 8 of the warp: running max (log2 units) and this lane's
  // share of the running sum.
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * LOG2E;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {      // stage st ^ 1 was last read before the barrier
      load_tile<BK, DP>(Ks + (st ^ 1) * BK * LDS, kb, a.skl, (kt + 1) * BK,
                        a.Lk, a.D, vec);
      load_tile<BK, DP>(Vs + (st ^ 1) * BK * LDS, vb, a.svl, (kt + 1) * BK,
                        a.Lk, a.D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kt_b = kB + st * BK * LDS * 2, vt_a = vA + st * BK * LDS * 2;
    if (Q_REGS && kt == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[Q_REGS ? kc : 0], qA + kc * 32);
    }

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      if (Q_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[Q_REGS ? kc : 0][r];
      } else {
        ldsm_x4(qa, qA + kc * 32);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, kt_b + (np * 16 * LDS + kc * 16) * 2);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // Scale to log2 units; keys past Lk get -1e30 (pallas_attention.py:138).
    const int kbase = kt * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kbase + n * 8 + 2 * t + (e & 1) < a.Lk;
        s[n][e] = ok ? s[n][e] * sl2 : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V: P's C fragments split into three bf16 A fragments (their
    // sum is the f32 P), V read transposed ([key][d] as stored is B's
    // [k][n]).
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[3][4];
      split3_bf16(s[2 * kc][0], s[2 * kc][1], pa, 0);
      split3_bf16(s[2 * kc][2], s[2 * kc][3], pa, 1);
      split3_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], pa, 2);
      split3_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], pa, 3);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vt_a + (kc * 16 * LDS + dp * 16) * 2);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(o[2 * dp], pa[i], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();        // stage st is refilled in the next iteration
  }

  // Epilogue: l == 0 -> 1 (pallas_attention.py:157); the warp's O rows go
  // through its own rows of the Q tile to 16-byte stores.
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  bf16* Ow = Qs + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Ow + g * LDS + n * 8 + 2 * t) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(Ow + (g + 8) * LDS + n * 8 + 2 * t) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  const int r0 = q0 + warp * 16;
  if (a.lse != nullptr && t == 0) {
    float* lse = a.lse + (int64_t)blockIdx.y * a.Lq;
    if (r0 + g < a.Lq) lse[r0 + g] = m0 * LN2 + logf(ls0);
    if (r0 + g + 8 < a.Lq) lse[r0 + g + 8] = m1 * LN2 + logf(ls1);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.o) + (int64_t)b * a.sob + (int64_t)h * a.soh;
  store_rows<DP>(ob, a.sol, Ow, r0, a.Lq, a.D, a.vec_out != 0, LDS);
}

template <int DP>
constexpr size_t fwd_mma_smem() {
  return (size_t)(BM + 4 * (DP <= 128 ? 64 : 32)) * (DP + 8) * sizeof(bf16);
}

template <int DP>
cudaError_t launch_mma(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<DP>();
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<DP>, smem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BM - 1) / BM, a.B * a.H);
  flash_fwd_mma_kernel<DP><<<grid, MMA_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const FlashArgs& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_mma<32>(a, stream);
  if (a.D <= 64) return launch_mma<64>(a, stream);
  if (a.D <= 128) return launch_mma<128>(a, stream);
  if (a.D <= 256) return launch_mma<256>(a, stream);
  return launch_wide<bf16>(a, stream);
}

// 16-byte access is possible for a bf16 [B, L, H, D] view when its base and
// every stride (in elements) and D are multiples of 8 elements.
bool aligned16(const void* p, long long s0, long long s1, long long s2,
               int D) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0 && D % 8 == 0;
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
// What bounds it on an H100.  Per (b, h) the dK/dV pass does 8 * L^2 * D
// flops (S, dP, dV, dK) against ~14 * L * D bytes in bf16 (q, o, dO, k, v
// in, dk, dv out), the dQ pass 6 * L^2 * D against ~10 * L * D: about L/2
// flops per byte, so in bf16 on the tensor cores both are bound by bytes
// at srn64's L <= 256 and by operations from L ~ 500.  Design:
//   * delta is computed once, in a pre-pass (one warp per query row), as
//     rowsum(dO * O) - glse into a [B, H, Lq] f32 scratch, so the two main
//     kernels read one number per row instead of re-reducing dO * O;
//   * the Pallas two-kernel split is kept so neither kernel needs atomics:
//     dK/dV, one block per key tile looping over query tiles; dQ, one block
//     per query tile looping over key tiles;
//   * bf16 at D <= 256: tensor cores (flash_bwd_dkdv_mma_kernel and
//     flash_bwd_dq_mma_kernel, below);
//   * f32, and bf16 above D = 256: the f32 CUDA cores.  Q, dO, K, V tiles
//     staged in shared memory as f32 with rows padded by one float
//     (conflict-free key-major reads); the BB x BB P and dS tiles never
//     leave shared memory.  BB = 32 rows up to D = 256 (4 x 32 x 257 + 2 x
//     32 x 33 floats = 140 KB at D = 256) and 16 above (4 x 16 x 513 + 2 x
//     16 x 17 floats = 134 KB at D = 512), inside the 227 KB a block may
//     use.

// Rows of a CUDA-core backward tile (keys or queries): 32 up to D = 256,
// 16 above (DCH > 8), so four tiles of 512 f32 columns fit a block.
template <int DCH>
__host__ __device__ constexpr int bwd_bb() {
  return DCH <= 8 ? 32 : 16;
}

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
  int vec_in, vec_out;             // 16-byte paths (tensor-core kernels only)
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
  constexpr int BB = bwd_bb<DCH>();
  return (size_t)4 * BB * (DCH * 32 + 1) + 2 * BB * (BB + 1) + 2 * BB;
}

// Stage rows [r0, r0 + BB) of a strided [L, D] head view as f32 (zeros past
// L and D).
template <typename T, int DCH>
__device__ __forceinline__ void stage(float* dst, const T* src, long long sl,
                                      int r0, int L, int D) {
  constexpr int BB = bwd_bb<DCH>(), DP = DCH * 32, LD = DP + 1;
  for (int e = threadIdx.x; e < BB * DP; e += NT) {
    const int i = e / DP, d = e % DP;
    float val = 0.f;
    if (r0 + i < L && d < D) val = load_f32<T>(src + (int64_t)(r0 + i) * sl + d);
    dst[i * LD + d] = val;
  }
}

// P and dS of one (query tile, key tile) pair into shared memory: thread
// (j, w) = (tid % BB, tid / BB) computes rows w + (NT / BB) r of key
// column j (4 rows at BB = 32, 1 at BB = 16).
template <int DCH>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s,
                                           const float* dl_s, float* P,
                                           float* dS, int nq, int nk,
                                           float scale) {
  constexpr int BB = bwd_bb<DCH>(), LD = DCH * 32 + 1;
  constexpr int RS = NT / BB, NR = BB / RS;
  const int j = threadIdx.x % BB, w = threadIdx.x / BB;
  float s[NR], dp[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < DCH * 32; ++d) {
    const float kd = Ks[j * LD + d], vd = Vs[j * LD + d];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] += Qs[(w + RS * r) * LD + d] * kd;
      dp[r] += dOs[(w + RS * r) * LD + d] * vd;
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = w + RS * r;
    const float p = (i < nq && j < nk) ? expf(s[r] * scale - lse_s[i]) : 0.f;
    P[i * (BB + 1) + j] = p;
    dS[i * (BB + 1) + j] = p * (dp[r] - dl_s[i]) * scale;
  }
}

// The CUDA-core dK/dV: f32 at any D, bf16 at D > 256.
template <typename T, int DCH>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(FlashBwdArgs a) {
  constexpr int BB = bwd_bb<DCH>(), DP = DCH * 32, LD = DP + 1;
  constexpr int NR = BB / 8;        // key rows a thread accumulates
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
  float dk[NR][DCH], dv[NR][DCH];
#pragma unroll
  for (int r = 0; r < NR; ++r)
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
      for (int r = 0; r < NR; ++r) {
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
  for (int r = 0; r < NR; ++r) {
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

// The CUDA-core dQ: f32 at any D, bf16 at D > 256.
template <typename T, int DCH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(FlashBwdArgs a) {
  constexpr int BB = bwd_bb<DCH>(), DP = DCH * 32, LD = DP + 1;
  constexpr int NR = BB / 8;        // query rows a thread accumulates
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
  float dq[NR][DCH];
#pragma unroll
  for (int r = 0; r < NR; ++r)
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
      for (int r = 0; r < NR; ++r) {
        const float ds = dS[(warp + 8 * r) * (BB + 1) + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) dq[r][c] += ds * kj[c];
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
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

// The bf16 dK/dV.  Replaces diff3d_tpu/ops/pallas_attention.py::
// _bwd_dkdv_kernel (pallas_attention.py:204-244, the `dkdv` call at :287)
// for bf16 operands at D <= 256; f32, and bf16 above D = 256, keep
// flash_bwd_dkdv_kernel above.
// Bound: per (b, h) 8 * L^2 * D flops against ~14 * L * D bytes (q, o, dO,
// k, v in with the delta pre-pass, dk, dv out, bf16) -- by bytes at srn64's
// L <= 256, by operations from L ~ 520.  Design: one CTA of 4 warps per
// (b * h, 64-key tile), each
// warp 16 key rows; dK and dV accumulate in f32 registers and are written
// once.  The loop runs over query tiles of BQ (64 at D <= 64, else 32),
// double-buffering Q, dO and the tile's lse and delta rows (16-byte
// cp.async, bf16 shared memory with 16-byte row padding).  The products are
// taken transposed, so each one's C fragment is the next one's A operand:
//   S^T = K Q^T and dP^T = V dO^T (Q, dO as stored are B's [n][k]);
//   P^T = exp(S^T * scale - lse[q]), dS^T = P^T (dP^T - delta[q]) * scale
//   in registers (exp2 with a log2(e) prescale; queries past Lq give 0);
//   dV += P^T dO and dK += dS^T Q (dO, Q read transposed by ldmatrix).
// Numerics: P^T and dS^T are rounded to bf16 before their products, as
// FlashAttention-2 does; sums stay f32.  At D = 256 the accumulators would
// not fit the registers, so grid.z splits the dK/dV columns in two halves
// (S^T and dP^T are computed by both).  K and V fragments stay in
// registers at D <= 64 and are re-read by ldmatrix above.
template <int DP>
__global__ void __launch_bounds__(MMA_NT)
    flash_bwd_dkdv_mma_kernel(FlashBwdArgs a) {
  constexpr int BQ = DP <= 64 ? 64 : 32;    // queries per tile
  constexpr int DW = DP > 128 ? DP / 2 : DP;  // dK/dV columns per CTA
  constexpr int LDS = DP + 8;
  constexpr int KC = DP / 16;               // k-chunks of S^T, dP^T
  // Their loops unroll fully below D = 128; at D >= 128 two at a time,
  // which keeps the accumulators in registers (no spills).
  constexpr int KU = DP >= 128 ? 2 : KC;
  constexpr int NS = BQ / 8;                // n-tiles of S^T
  constexpr int NW = DW / 8;                // n-tiles of dK, dV
  constexpr bool KV_REGS = DP <= 64;
  extern __shared__ float4 smem_f4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_f4);  // [BM][LDS]
  bf16* Vs = Ks + BM * LDS;                      // [BM][LDS]
  bf16* Qs = Vs + BM * LDS;                      // [2][BQ][LDS]
  bf16* dOs = Qs + 2 * BQ * LDS;                 // [2][BQ][LDS]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                  // [2][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BM, d0 = blockIdx.z * DW;
  const bf16* qb = static_cast<const bf16*>(a.q) + (int64_t)b * a.sqb +
                   (int64_t)h * a.sqh;
  const bf16* kb = static_cast<const bf16*>(a.k) + (int64_t)b * a.skb +
                   (int64_t)h * a.skh;
  const bf16* vb = static_cast<const bf16*>(a.v) + (int64_t)b * a.svb +
                   (int64_t)h * a.svh;
  const bf16* db = static_cast<const bf16*>(a.dO) + (int64_t)b * a.sdb +
                   (int64_t)h * a.sdh;
  const float* lse = a.lse + (int64_t)bh * a.Lq;
  const float* delta = a.delta + (int64_t)bh * a.Lq;
  const bool vec = a.vec_in != 0;
  const int nq = (a.Lq + BQ - 1) / BQ;

  // lse in log2 units and delta for query rows [q0, q0 + BQ), zeros past Lq.
  auto stage_rows = [&](int q0, int st) {
    if (tid < BQ) {
      const bool ok = q0 + tid < a.Lq;
      lse_s[st * BQ + tid] = ok ? lse[q0 + tid] * LOG2E : 0.f;
      dl_s[st * BQ + tid] = ok ? delta[q0 + tid] : 0.f;
    }
  };
  load_tile<BM, DP>(Ks, kb, a.skl, k0, a.Lk, a.D, vec);
  load_tile<BM, DP>(Vs, vb, a.svl, k0, a.Lk, a.D, vec);
  load_tile<BQ, DP>(Qs, qb, a.sql, 0, a.Lq, a.D, vec);
  load_tile<BQ, DP>(dOs, db, a.sdl, 0, a.Lq, a.D, vec);
  stage_rows(0, 0);
  cp_async_commit();

  // Shared byte addresses of this lane's ldmatrix rows: the warp's 16 key
  // rows of K and V (A), stage 0 of Q and dO as stored (B) and transposed
  // (B, from column d0).
  const uint32_t kA = smem_u32(Ks) + warp * 16 * LDS * 2 + a_off<LDS>(lane);
  const uint32_t vA = smem_u32(Vs) + warp * 16 * LDS * 2 + a_off<LDS>(lane);
  const uint32_t qB = smem_u32(Qs) + b_off<LDS>(lane);
  const uint32_t dB = smem_u32(dOs) + b_off<LDS>(lane);
  const uint32_t qT = smem_u32(Qs) + a_off<LDS>(lane) + d0 * 2;
  const uint32_t dT = smem_u32(dOs) + a_off<LDS>(lane) + d0 * 2;
  uint32_t kf[KV_REGS ? KC : 1][4], vf[KV_REGS ? KC : 1][4];
  float dk[NW][4], dv[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl2 = a.scale * LOG2E;

  for (int it = 0; it < nq; ++it) {
    const int st = it & 1, q0 = it * BQ;
    if (it + 1 < nq) {      // stage st ^ 1 was last read before the barrier
      load_tile<BQ, DP>(Qs + (st ^ 1) * BQ * LDS, qb, a.sql, q0 + BQ, a.Lq,
                        a.D, vec);
      load_tile<BQ, DP>(dOs + (st ^ 1) * BQ * LDS, db, a.sdl, q0 + BQ, a.Lq,
                        a.D, vec);
      stage_rows(q0 + BQ, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t so = st * BQ * LDS * 2;  // byte offset of stage st
    const float* lt = lse_s + st * BQ;
    const float* dlt = dl_s + st * BQ;
    if (KV_REGS && it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldsm_x4(kf[KV_REGS ? kc : 0], kA + kc * 32);
        ldsm_x4(vf[KV_REGS ? kc : 0], vA + kc * 32);
      }
    }

    // S^T = K Q^T, then dP^T = V dO^T: [16 keys][BQ queries] per warp.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll (KU)
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4];
      if (KV_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) ka[r] = kf[KV_REGS ? kc : 0][r];
      } else {
        ldsm_x4(ka, kA + kc * 32);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t f[4];
        ldsm_x4(f, qB + so + (np * 16 * LDS + kc * 16) * 2);
        mma_bf16(s[2 * np], ka, f[0], f[1]);
        mma_bf16(s[2 * np + 1], ka, f[2], f[3]);
      }
    }
#pragma unroll (KU)
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t va[4];
      if (KV_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) va[r] = vf[KV_REGS ? kc : 0][r];
      } else {
        ldsm_x4(va, vA + kc * 32);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t f[4];
        ldsm_x4(f, dB + so + (np * 16 * LDS + kc * 16) * 2);
        mma_bf16(dp[2 * np], va, f[0], f[1]);
        mma_bf16(dp[2 * np + 1], va, f[2], f[3]);
      }
    }

    // P^T and dS^T, column (query) 8n + 2t + (e & 1), packed to bf16 A
    // fragments: 16 queries (two n-tiles) per fragment.
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        p[e] = q0 + c < a.Lq ? exp2f(s[n][e] * sl2 - lt[c]) : 0.f;
        ds[e] = p[e] * (dp[n][e] - dlt[c]) * a.scale;
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      sa[n / 2][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      sa[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, then dK += dS^T Q, over columns [d0, d0 + DW).
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t f[4];
        ldsm_x4_t(f, dT + so + (kc * 16 * LDS + np * 16) * 2);
        mma_bf16(dv[2 * np], pa[kc], f[0], f[1]);
        mma_bf16(dv[2 * np + 1], pa[kc], f[2], f[3]);
      }
    }
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t f[4];
        ldsm_x4_t(f, qT + so + (kc * 16 * LDS + np * 16) * 2);
        mma_bf16(dk[2 * np], sa[kc], f[0], f[1]);
        mma_bf16(dk[2 * np + 1], sa[kc], f[2], f[3]);
      }
    }
    __syncthreads();        // stage st is refilled in the next iteration
  }

  // Epilogue: the warp's dK and dV rows through its own rows of the K and
  // V tiles (columns [d0, d0 + DW)) to 16-byte stores.
  const int g = lane >> 2;
  bf16* dKw = Ks + warp * 16 * LDS;
  bf16* dVw = Vs + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    const int c = d0 + n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dKw + g * LDS + c) =
        __floats2bfloat162_rn(dk[n][0], dk[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dKw + (g + 8) * LDS + c) =
        __floats2bfloat162_rn(dk[n][2], dk[n][3]);
    *reinterpret_cast<__nv_bfloat162*>(dVw + g * LDS + c) =
        __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dVw + (g + 8) * LDS + c) =
        __floats2bfloat162_rn(dv[n][2], dv[n][3]);
  }
  __syncwarp();
  // dk / dv are contiguous [B, Lk, H, D]: row stride H * D.  Columns outside
  // [d0, d0 + DW) belong to the other half's CTA: offset the views by d0.
  const long long sl = (long long)a.H * a.D;
  const int64_t off = ((int64_t)b * a.Lk * a.H + h) * a.D + d0;
  const int r0 = k0 + warp * 16;
  store_rows<DW>(static_cast<bf16*>(a.dk) + off, sl, dKw + d0, r0, a.Lk,
                 a.D - d0, a.vec_out != 0, LDS);
  store_rows<DW>(static_cast<bf16*>(a.dv) + off, sl, dVw + d0, r0, a.Lk,
                 a.D - d0, a.vec_out != 0, LDS);
}

template <int DP>
constexpr size_t dkdv_mma_smem() {
  constexpr int BQ = DP <= 64 ? 64 : 32;
  return (size_t)(2 * BM + 4 * BQ) * (DP + 8) * sizeof(bf16) +
         4 * BQ * sizeof(float);
}

template <int DP>
cudaError_t launch_dkdv_mma(const FlashBwdArgs& a, cudaStream_t stream) {
  const size_t smem = dkdv_mma_smem<DP>();
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dkdv_mma_kernel<DP>, smem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + BM - 1) / BM, a.B * a.H, DP > 128 ? 2 : 1);
  flash_bwd_dkdv_mma_kernel<DP><<<grid, MMA_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dkdv_bf16(const FlashBwdArgs& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_dkdv_mma<32>(a, stream);
  if (a.D <= 64) return launch_dkdv_mma<64>(a, stream);
  if (a.D <= 128) return launch_dkdv_mma<128>(a, stream);
  if (a.D <= 256) return launch_dkdv_mma<256>(a, stream);
  return cudaErrorInvalidValue;
}

// The bf16 dQ.  Replaces diff3d_tpu/ops/pallas_attention.py::_bwd_dq_kernel
// (pallas_attention.py:247-275, the `dq` call at :306) for bf16 operands
// at D <= 256; the f32 path, and bf16 above D = 256, keep
// flash_bwd_dq_kernel above.  Bound: per (b, h) 6 * L^2 * D flops against
// ~10 * L * D bytes (q, dO, k, v in, dq out, bf16, with the lse and delta
// rows) -- by bytes at srn64's L <= 256, by operations from L ~ 600.
// Design, the mirror image of flash_bwd_dkdv_mma_kernel: one CTA of 4
// warps per (b * h, 64-query tile), each warp 16 query rows; the loop runs
// over key tiles of BK (64 at D <= 64, else 32), K and V double-buffered
// through 16-byte cp.async into bf16 shared memory with 16-byte row
// padding.  Per tile, in registers:
//   S = Q K^T and dP = dO V^T (K, V as stored are B's [n][k]);
//   P = exp(S * scale - lse), keys past Lk giving 0 (exp2 with a log2(e)
//   prescale), dS = P (dP - delta) * scale, packed to bf16 A fragments;
//   dQ += dS K, K read transposed by ldmatrix.
// Numerics: dS is rounded to bf16 before dS K, as FlashAttention-2 does
// and as the dK/dV kernel does for dS^T; sums stay f32.  The warp's Q and
// dO fragments, its two rows' lse and delta stay in registers for the key
// loop (Q and dO only at D <= 64; above they are re-read by ldmatrix).  At
// D = 256 grid.z splits the dQ columns in two halves (S and dP are
// computed by both), which keeps the accumulators in registers.
template <int DP>
__global__ void __launch_bounds__(MMA_NT)
    flash_bwd_dq_mma_kernel(FlashBwdArgs a) {
  constexpr int BK = DP <= 64 ? 64 : 32;    // keys per tile
  constexpr int DW = DP > 128 ? DP / 2 : DP;  // dQ columns per CTA
  constexpr int LDS = DP + 8;
  constexpr int KC = DP / 16;               // k-chunks of S, dP
  constexpr int KU = DP >= 128 ? 2 : KC;    // their unroll (no spills)
  constexpr int NS = BK / 8;                // n-tiles of S, dP
  constexpr int NW = DW / 8;                // n-tiles of dQ
  constexpr bool QD_REGS = DP <= 64;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);  // [BM][LDS]
  bf16* dOs = Qs + BM * LDS;                     // [BM][LDS]
  bf16* Ks = dOs + BM * LDS;                     // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                  // [2][BK][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BM, d0 = blockIdx.z * DW;
  const bf16* qb = static_cast<const bf16*>(a.q) + (int64_t)b * a.sqb +
                   (int64_t)h * a.sqh;
  const bf16* kb = static_cast<const bf16*>(a.k) + (int64_t)b * a.skb +
                   (int64_t)h * a.skh;
  const bf16* vb = static_cast<const bf16*>(a.v) + (int64_t)b * a.svb +
                   (int64_t)h * a.svh;
  const bf16* db = static_cast<const bf16*>(a.dO) + (int64_t)b * a.sdb +
                   (int64_t)h * a.sdh;
  const bool vec = a.vec_in != 0;
  const int nk = (a.Lk + BK - 1) / BK;

  load_tile<BM, DP>(Qs, qb, a.sql, q0, a.Lq, a.D, vec);
  load_tile<BM, DP>(dOs, db, a.sdl, q0, a.Lq, a.D, vec);
  load_tile<BK, DP>(Ks, kb, a.skl, 0, a.Lk, a.D, vec);
  load_tile<BK, DP>(Vs, vb, a.svl, 0, a.Lk, a.D, vec);
  cp_async_commit();

  // This lane's rows g and g + 8 of the warp: lse in log2 units and delta
  // (zeros past Lq: those rows are not stored).
  const int r0 = q0 + warp * 16;
  const float* lse = a.lse + (int64_t)bh * a.Lq;
  const float* delta = a.delta + (int64_t)bh * a.Lq;
  const float lt0 = r0 + g < a.Lq ? lse[r0 + g] * LOG2E : 0.f;
  const float lt1 = r0 + g + 8 < a.Lq ? lse[r0 + g + 8] * LOG2E : 0.f;
  const float dl0 = r0 + g < a.Lq ? delta[r0 + g] : 0.f;
  const float dl1 = r0 + g + 8 < a.Lq ? delta[r0 + g + 8] : 0.f;

  // Shared byte addresses of this lane's ldmatrix rows: the warp's 16
  // query rows of Q and dO (A), stage 0 of K and V as stored (B) and of K
  // transposed (B, from column d0).
  const uint32_t qA = smem_u32(Qs) + warp * 16 * LDS * 2 + a_off<LDS>(lane);
  const uint32_t dA = smem_u32(dOs) + warp * 16 * LDS * 2 + a_off<LDS>(lane);
  const uint32_t kB = smem_u32(Ks) + b_off<LDS>(lane);
  const uint32_t vB = smem_u32(Vs) + b_off<LDS>(lane);
  const uint32_t kT = smem_u32(Ks) + a_off<LDS>(lane) + d0 * 2;
  uint32_t qf[QD_REGS ? KC : 1][4], df[QD_REGS ? KC : 1][4];
  float dq[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float sl2 = a.scale * LOG2E;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {      // stage st ^ 1 was last read before the barrier
      load_tile<BK, DP>(Ks + (st ^ 1) * BK * LDS, kb, a.skl, (kt + 1) * BK,
                        a.Lk, a.D, vec);
      load_tile<BK, DP>(Vs + (st ^ 1) * BK * LDS, vb, a.svl, (kt + 1) * BK,
                        a.Lk, a.D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t so = st * BK * LDS * 2;  // byte offset of stage st
    if (QD_REGS && kt == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldsm_x4(qf[QD_REGS ? kc : 0], qA + kc * 32);
        ldsm_x4(df[QD_REGS ? kc : 0], dA + kc * 32);
      }
    }

    // S = Q K^T, then dP = dO V^T: [16 queries][BK keys] per warp.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll (KU)
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      if (QD_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[QD_REGS ? kc : 0][r];
      } else {
        ldsm_x4(qa, qA + kc * 32);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t f[4];
        ldsm_x4(f, kB + so + (np * 16 * LDS + kc * 16) * 2);
        mma_bf16(s[2 * np], qa, f[0], f[1]);
        mma_bf16(s[2 * np + 1], qa, f[2], f[3]);
      }
    }
#pragma unroll (KU)
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t da[4];
      if (QD_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) da[r] = df[QD_REGS ? kc : 0][r];
      } else {
        ldsm_x4(da, dA + kc * 32);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t f[4];
        ldsm_x4(f, vB + so + (np * 16 * LDS + kc * 16) * 2);
        mma_bf16(dp[2 * np], da, f[0], f[1]);
        mma_bf16(dp[2 * np + 1], da, f[2], f[3]);
      }
    }

    // dS, key column 8n + 2t + (e & 1), row g (e < 2) or g + 8, packed to
    // bf16 A fragments: 16 keys (two n-tiles) per fragment.
    const int kbase = kt * BK;
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kbase + n * 8 + 2 * t + (e & 1) < a.Lk;
        const float p = ok ? exp2f(s[n][e] * sl2 - (e < 2 ? lt0 : lt1)) : 0.f;
        ds[e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * a.scale;
      }
      sa[n / 2][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      sa[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K over columns [d0, d0 + DW).
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t f[4];
        ldsm_x4_t(f, kT + so + (kc * 16 * LDS + np * 16) * 2);
        mma_bf16(dq[2 * np], sa[kc], f[0], f[1]);
        mma_bf16(dq[2 * np + 1], sa[kc], f[2], f[3]);
      }
    }
    __syncthreads();        // stage st is refilled in the next iteration
  }

  // Epilogue: the warp's dQ rows through its own rows of the Q tile
  // (columns [d0, d0 + DW)) to 16-byte stores.
  bf16* dQw = Qs + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    const int c = d0 + n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dQw + g * LDS + c) =
        __floats2bfloat162_rn(dq[n][0], dq[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dQw + (g + 8) * LDS + c) =
        __floats2bfloat162_rn(dq[n][2], dq[n][3]);
  }
  __syncwarp();
  // dq is contiguous [B, Lq, H, D]: row stride H * D, offset by d0.
  const long long sl = (long long)a.H * a.D;
  const int64_t off = ((int64_t)b * a.Lq * a.H + h) * a.D + d0;
  store_rows<DW>(static_cast<bf16*>(a.dq) + off, sl, dQw + d0, r0, a.Lq,
                 a.D - d0, a.vec_out != 0, LDS);
}

template <int DP>
constexpr size_t dq_mma_smem() {
  constexpr int BK = DP <= 64 ? 64 : 32;
  return (size_t)(2 * BM + 4 * BK) * (DP + 8) * sizeof(bf16);
}

template <int DP>
cudaError_t launch_dq_mma(const FlashBwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_mma_smem<DP>();
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<DP>, smem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BM - 1) / BM, a.B * a.H, DP > 128 ? 2 : 1);
  flash_bwd_dq_mma_kernel<DP><<<grid, MMA_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dq_bf16(const FlashBwdArgs& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_dq_mma<32>(a, stream);
  if (a.D <= 64) return launch_dq_mma<64>(a, stream);
  if (a.D <= 128) return launch_dq_mma<128>(a, stream);
  if (a.D <= 256) return launch_dq_mma<256>(a, stream);
  return cudaErrorInvalidValue;
}

// The CUDA-core dK/dV (part 0) or dQ (part 1).
template <typename T, int DCH>
cudaError_t launch_bwd(const FlashBwdArgs& a, int part, cudaStream_t stream) {
  constexpr int BB = bwd_bb<DCH>();
  const size_t smem = bwd_smem_floats<DCH>() * sizeof(float);
  if (part == 0) {
    static unsigned long long done_dkdv = 0;
    cudaError_t err =
        allow_smem(flash_bwd_dkdv_kernel<T, DCH>, smem, &done_dkdv);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, DCH>
        <<<dim3((a.Lk + BB - 1) / BB, a.B * a.H), NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  static unsigned long long done_dq = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DCH>, smem, &done_dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DCH>
      <<<dim3((a.Lq + BB - 1) / BB, a.B * a.H), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// Part 0: the delta pre-pass, then dK/dV; part 1: dQ.  bf16 at D <= 256
// takes the tensor-core kernels; f32, and bf16 above D = 256 (head dim
// padded to 384 or 512), the CUDA-core ones.
template <typename T>
cudaError_t launch_bwd_d(const FlashBwdArgs& a, int part,
                         cudaStream_t stream) {
  if (part == 0) {
    flash_bwd_delta_kernel<T>
        <<<dim3((a.Lq + NT / 32 - 1) / (NT / 32), a.B * a.H), NT, 0,
           stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.D > 384) return launch_bwd<T, 16>(a, part, stream);
  if (a.D > 256) return launch_bwd<T, 12>(a, part, stream);
  if constexpr (sizeof(T) == 2) {
    return part == 0 ? launch_dkdv_bf16(a, stream) : launch_dq_bf16(a, stream);
  } else {
    switch ((a.D + 31) / 32) {
      case 1: return launch_bwd<T, 1>(a, part, stream);
      case 2: return launch_bwd<T, 2>(a, part, stream);
      case 3: return launch_bwd<T, 3>(a, part, stream);
      case 4: return launch_bwd<T, 4>(a, part, stream);
      case 5: return launch_bwd<T, 5>(a, part, stream);
      case 6: return launch_bwd<T, 6>(a, part, stream);
      case 7: return launch_bwd<T, 7>(a, part, stream);
      default: return launch_bwd<T, 8>(a, part, stream);
    }
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
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > MAX_D ||
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
  a.vec_in = aligned16(q, sqb, sql, sqh, D) &&
             aligned16(k, skb, skl, skh, D) && aligned16(v, svb, svl, svh, D);
  a.vec_out = aligned16(o, sob, sol, soh, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_f32(a, st) : launch_bf16(a, st);
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
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > MAX_D ||
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
  // dk / dv are contiguous [B, Lk, H, D].
  a.vec_in = aligned16(q, sqb, sql, sqh, D) &&
             aligned16(k, skb, skl, skh, D) &&
             aligned16(v, svb, svl, svh, D) && aligned16(dO, sdb, sdl, sdh, D);
  a.vec_out = part == 0
                  ? aligned16(dk, 0, 0, 0, D) && aligned16(dv, 0, 0, 0, D)
                  : aligned16(dq, 0, 0, 0, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_bwd_d<float>(a, part, st)
                               : launch_bwd_d<__nv_bfloat16>(a, part, st);
  return (int)err;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
