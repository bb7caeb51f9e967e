// Fused GroupNorm -> (FiLM) -> (SiLU) over x [N, L, C]: forward (with the
// per-group mean / rstd residual when asked, save_stats) and backward
// (below the forward).
//
// Forward.  Replaces the TPU kernel diff3d_tpu/ops/pallas_film.py::
// _fwd_kernel (launched by _fwd_call, pallas_film.py:277).  Same function:
// f32 per-group statistics as E[x^2] - mean^2 clamped at 0, eps 1e-5, the
// gamma/beta affine, the optional per-pixel FiLM y * (1 + scale) + shift,
// the optional SiLU, all in f32 and rounded once at the output.
//
// What bounds it on an H100: bytes.  It does ~10 flops per element against
// reading x (and scale, shift) once and writing the output once, far below
// the 295 flop/byte ridge.  At the srn64 train step's 64^2 level one bf16
// tensor is 256 * 4096 * 128 * 2 = 268 MB, so x does not stay in the 50 MB
// L2 between two passes over the whole tensor.  Design: one thread-block
// cluster of CS CTAs per sample n (gn_fwd_cluster_kernel), so the
// statistics and the apply of a sample share one kernel and one read of x:
//   * phase 1: CTA `rank` of the cluster takes rows [rank * R, ...).  Each
//     lane owns 16 bytes of channels (8 bf16 or 4 f32; element loads when
//     a view is not 16-byte aligned) and sums x and x^2 over its rows in
//     f64, eight rows in flight.  Where the plan keeps x on chip (`onchip`), the CTA's
//     rows arrive in shared memory by cp.async in NCHUNK commit groups and
//     the sums read them from there; else x is read with an L2 evict_last
//     hint so that phase 2's re-read of the sample's slab (<= 3 MB at
//     srn64) finds it in L2.  Lane sums fold to channels, then to groups,
//     in shared memory, in a fixed order;
//   * exchange: after cluster.sync() every CTA reads the CS group partials
//     of all CTAs through distributed shared memory in rank order, so
//     every CTA computes the same mean / rstd and a call is bit-identical
//     run to run (no float atomics); rank 0 writes the [2, N, G] stats.  A
//     second cluster.sync() keeps every CTA's partials alive while a peer
//     reads them;
//   * phase 2: each CTA normalises its rows from the x it kept (or
//     re-reads them), reads scale and shift once (the two strided halves
//     of the FiLM Dense output, row stride 2C), and writes the output with
//     16-byte stores; scale, shift, the re-read x and the output stream
//     through L2 with an evict_first hint.  The element chain repeats the
//     plain version's operations one by one, each rounded to f32 (no fused
//     multiply-adds; SiLU's sigmoid the precise 1 / (1 + expf(-y))), so
//     that the bf16 output matches it bit for bit wherever the statistics
//     do: with fused multiply-adds and the hardware exp2, a few outputs in
//     10^4 rounded the other way and moved the tiny bf16 model's gradients
//     0.107 from the plain path, past the card test's 0.1.
// The host plan (cuda_film.forward_plan) picks CS (1..16), R and `onchip`
// per call from N, L, C and the dtype.  One launch, no scratch buffer.
// Launch errors are returned to the caller (cudaGetLastError after each
// launch); nothing here synchronises or allocates.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;    // non-portable cluster size limit
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use
// Rows a CTA keeps on chip arrive in NCHUNK commit groups, so phase 1
// starts on the first rows while the rest stream in.
constexpr int NCHUNK = 4;

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

// W consecutive elements of T as stored: one 16-byte word when
// W * sizeof(T) == 16, else W == 1 and one element.
template <typename T, int W>
using Raw = typename std::conditional<(W > 1), uint4, T>::type;

template <typename T, int W>
__device__ __forceinline__ void unpack(const Raw<T, W>& u, float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = load_f32<T>(&u);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ Raw<T, W> pack(const float (&v)[W]) {
  if constexpr (W == 1) {
    return from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// W consecutive elements of T as f32, and back: one 16-byte access when
// W * sizeof(T) == 16, else W == 1.
template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[W]) {
  unpack<T, W>(*reinterpret_cast<const Raw<T, W>*>(p), v);
}

template <typename T, int W>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[W]) {
  *reinterpret_cast<Raw<T, W>*>(p) = pack<T, W>(v);
}

// 16 bytes global -> shared, asynchronously (the caller commits and waits).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(src)
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

// L2 eviction policies for ld_l2 / st_l2: evict_last for data read again
// soon, evict_first for data read or written once.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 bytes from / to global memory under an L2 eviction policy.  The
// inputs are never written by the kernel that loads them.
__device__ __forceinline__ uint4 ld_l2(const void* p, uint64_t policy) {
  uint4 u;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p), "l"(policy));
  return u;
}

__device__ __forceinline__ void st_l2(void* p, uint4 u, uint64_t policy) {
  asm volatile(
      "st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n"
      :
      : "l"(p), "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w), "l"(policy)
      : "memory");
}

// The hinted accesses for W elements (plain ones when W == 1).
template <typename T, int W>
__device__ __forceinline__ Raw<T, W> ld_hint(const T* p, uint64_t policy) {
  if constexpr (W == 1) {
    return *p;
  } else {
    return ld_l2(p, policy);
  }
}

template <typename T, int W>
__device__ __forceinline__ void st_hint(T* p, const Raw<T, W>& v,
                                        uint64_t policy) {
  if constexpr (W == 1) {
    *p = v;
  } else {
    st_l2(p, v, policy);
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes` (and, with
// `cluster`, allow non-portable cluster sizes) once per device: the
// attributes persist, and setting them costs a runtime call otherwise.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long* done,
                       bool cluster = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// A cluster launch configuration: grid (cs, N), one cluster per sample.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int cs, int N, int threads, size_t smem,
                cudaStream_t stream) {
    cfg.gridDim = dim3(cs, N);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// 16-byte access to a [N, L, C] view: base, strides (in elements) and C
// are multiples of W = 16 / sizeof(T) elements.
bool aligned16(const void* p, long long sn, long long sl, int C, int W) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sn % W == 0 &&
         sl % W == 0 && C % W == 0;
}

// ---------------------------------------------------------------------------
// Forward.

constexpr int FWD_NT = 256;        // threads of a forward cluster CTA

struct GnFwdArgs {
  const void* x;
  long long sxn, sxl;              // element strides of x (channel stride 1)
  const float* gamma;
  const float* beta;
  const void* scale;
  long long ssn, ssl;
  const void* shift;
  long long shn, shl;
  void* out;                       // contiguous [N, L, C]
  float* stats;                    // [2, N, G] mean, rstd, or null
  int N, L, C, G, rows_per_cta, onchip;
  int film, silu;                  // read by the element kernel (W == 1)
  float eps;
};

// Doubles of a forward CTA's fold buffers (csum, csq [C]; s1, s2 [G];
// red [FWD_NT][W]), rounded up to 16 bytes; x of its rows follows them.
__host__ __device__ constexpr int fwd_aux_doubles(int C, int G, int W) {
  return (2 * C + 2 * G + FWD_NT * W + 1) & ~1;
}

template <typename T, int W, bool FILM, bool SILU>
__global__ void __launch_bounds__(FWD_NT, 2)
    gn_fwd_cluster_kernel(GnFwdArgs a) {
  using R = Raw<T, W>;
  // The 16-byte-lane kernels are built per mode; the element kernel, for
  // views that are not 16-byte aligned, reads the mode at run time.
  const bool film = W > 1 ? FILM : a.film != 0;
  const bool silu = W > 1 ? SILU : a.silu != 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y, tid = threadIdx.x;
  const int C = a.C, G = a.G, gs = C / G;
  extern __shared__ float4 smem_f4[];
  double* csum = reinterpret_cast<double*>(smem_f4);  // [C] sum of x
  double* csq = csum + C;          // [C] sum of x^2
  double* s1 = csq + C;            // [G] group sums of csum (read by peers)
  double* s2 = s1 + G;             // [G] group sums of csq  (read by peers)
  double* red = s2 + G;            // [FWD_NT][W] fold scratch
  // After the exchange: each group's mean and rstd, over csum.
  float* gmean = reinterpret_cast<float*>(csum);
  float* grstd = gmean + G;
  T* xs = reinterpret_cast<T*>(reinterpret_cast<double*>(smem_f4) +
                               fwd_aux_doubles(C, G, W));   // [R][C]

  const int r0 = min(a.L, rank * a.rows_per_cta);
  const int r1 = min(a.L, r0 + a.rows_per_cta);
  const bool onchip = a.onchip != 0;
  // Lane layout: SP channel slots of W channels per pass, RY rows in
  // flight; passes over slots [cv0, cv0 + SP) when C / W > FWD_NT.  Lane
  // row group ry takes rows r0 + ry, r0 + ry + RY, ...
  const int NV = C / W;
  const int SP = min(NV, FWD_NT), RY = FWD_NT / SP;
  const int sv = tid % SP, ry = tid / SP;
  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn;
  const T* scn = static_cast<const T*>(a.scale) + (int64_t)n * a.ssn;
  const T* shn = static_cast<const T*>(a.shift) + (int64_t)n * a.shn;
  T* on = static_cast<T*>(a.out) + (int64_t)n * a.L * C;
  // Rows per chunk, a multiple of RY: a lane's rows do not depend on the
  // chunking.
  const int rc = ((r1 - r0 + NCHUNK - 1) / NCHUNK + RY - 1) / RY * RY;
  const uint64_t keep = l2_evict_last();
  const uint64_t once = l2_evict_first();

  // On chip: every row of x into shared memory, chunk by chunk (one commit
  // group each), 16 bytes a copy; element by element when the view is not
  // 16-byte aligned.
  if (onchip) {
    if constexpr (W > 1) {
      const uint32_t sx = (uint32_t)__cvta_generic_to_shared(xs);
      for (int q = 0; q < NCHUNK; ++q) {
        const int i0 = min(r1 - r0, q * rc), i1 = min(r1 - r0, i0 + rc);
        for (int e = i0 * NV + tid; e < i1 * NV; e += FWD_NT) {
          const int i = e / NV, c0 = (e % NV) * W;
          cp_async16(sx + (uint32_t)(((size_t)i * C + c0) * sizeof(T)),
                     xn + (int64_t)(r0 + i) * a.sxl + c0);
        }
        cp_async_commit();
      }
    } else {
      for (int e = tid; e < (r1 - r0) * C; e += FWD_NT) {
        const int i = e / C, c = e % C;
        xs[(size_t)i * C + c] = xn[(int64_t)(r0 + i) * a.sxl + c];
      }
      __syncthreads();
    }
  }

  // Phase 1: per-lane sums of x and x^2 in f64 (x^2 of an f32 is exact
  // there, and the sums lose nothing that the f32 statistics keep),
  // folded to channels.
  for (int cv0 = 0; cv0 < NV; cv0 += SP) {
    const int cv = cv0 + sv;
    const bool act = ry < RY && cv < NV;
    const int c0 = cv * W;
    double s[W], q[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = q[w] = 0.0;
    // Rows rs + ry, rs + ry + RY, ... below re, NB at a time: the loads of
    // all NB rows are issued before the adds.
    auto sum_rows = [&](int rs, int re, auto&& ld) {
      constexpr int NB = 8;
      auto add = [&](const R& u) {
        float v[W];
        unpack<T, W>(u, v);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const double d = v[w];
          s[w] += d;
          q[w] += d * d;
        }
      };
      int r = rs + ry;
      for (; r + (NB - 1) * RY < re; r += NB * RY) {
        R in[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) in[b] = ld(r + b * RY);
#pragma unroll
        for (int b = 0; b < NB; ++b) add(in[b]);
      }
      for (; r < re; r += RY) add(ld(r));
    };
    if (onchip) {
      auto ld = [&](int r) {
        return *reinterpret_cast<const R*>(xs + (size_t)(r - r0) * C + c0);
      };
      for (int k = 0; k < NCHUNK; ++k) {
        if (W > 1 && cv0 == 0) {   // chunk k of the copies has landed
          if (k == 0) cp_async_wait<NCHUNK - 1>();
          else if (k == 1) cp_async_wait<NCHUNK - 2>();
          else if (k == 2) cp_async_wait<NCHUNK - 3>();
          else cp_async_wait<0>();
          __syncthreads();
        }
        const int rs = min(r1, r0 + k * rc), re = min(r1, rs + rc);
        if (act) sum_rows(rs, re, ld);
      }
    } else if (act) {
      sum_rows(r0, r1, [&](int r) {
        return ld_hint<T, W>(xn + (int64_t)r * a.sxl + c0, keep);
      });
    }
    // Fold the RY row groups of each channel in order into csum, csq:
    // channel j of the pass is summed by thread j.
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      __syncthreads();
#pragma unroll
      for (int w = 0; w < W; ++w) red[tid * W + w] = p == 0 ? s[w] : q[w];
      __syncthreads();
      double* dst = p == 0 ? csum : csq;
      for (int j = tid; j < SP * W; j += FWD_NT) {
        if (cv0 * W + j >= C) continue;
        double t = 0.0;
        for (int k = 0; k < RY; ++k) t += red[j + k * SP * W];
        dst[cv0 * W + j] = t;
      }
    }
  }
  __syncthreads();
  // Channels to groups, in channel order.
  for (int gi = tid; gi < G; gi += FWD_NT) {
    double t1 = 0.0, t2 = 0.0;
    for (int k = 0; k < gs; ++k) {
      t1 += csum[gi * gs + k];
      t2 += csq[gi * gs + k];
    }
    s1[gi] = t1;
    s2[gi] = t2;
  }
  cluster.sync();

  // Exchange, in rank order: every CTA of the cluster sums the same
  // partials in the same order, four ranks' remote loads issued before
  // their sums.  The group mean / rstd overwrite csum, which no peer
  // reads.  From the sums on, the plain version's f32 operations, each
  // rounded: mean = sum * (1 / count), as torch's mean; var = E[x^2] -
  // mean^2 clamped at 0; rstd = rsqrt(var + eps).
  const float inv_count = 1.f / ((float)a.L * (float)gs);
  for (int gi = tid; gi < G; gi += FWD_NT) {
    double t1 = 0.0, t2 = 0.0;
    for (int k0 = 0; k0 < cs; k0 += 4) {   // 4 ranks' loads in flight
      double v1[4], v2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k0 + k < cs) {
          v1[k] = cluster.map_shared_rank(s1, k0 + k)[gi];
          v2[k] = cluster.map_shared_rank(s2, k0 + k)[gi];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k0 + k < cs) {
          t1 += v1[k];
          t2 += v2[k];
        }
      }
    }
    const float mean = __fmul_rn((float)t1, inv_count);
    const float mean2 = __fmul_rn((float)t2, inv_count);
    const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(__fadd_rn(var, a.eps));
    gmean[gi] = mean;
    grstd[gi] = rstd;
    if (a.stats != nullptr && rank == 0) {
      a.stats[(int64_t)n * G + gi] = mean;
      a.stats[((int64_t)a.N + n) * G + gi] = rstd;
    }
  }
  // No CTA leaves while a peer still reads its s1 / s2; the group mean /
  // rstd are visible to the whole CTA.
  cluster.sync();

  // Phase 2: the output of this CTA's rows.
  for (int cv0 = 0; cv0 < NV; cv0 += SP) {
    const int cv = cv0 + sv;
    if (!(ry < RY && cv < NV)) continue;
    const int c0 = cv * W;
    float gam[W], bet[W], mu[W], rs[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int c = c0 + w;
      gam[w] = a.gamma[c];
      bet[w] = a.beta[c];
      mu[w] = gmean[c / gs];
      rs[w] = grstd[c / gs];
    }
    auto ld_x = [&](int r) -> R {
      if (onchip)
        return *reinterpret_cast<const R*>(xs + (size_t)(r - r0) * C + c0);
      return ld_hint<T, W>(xn + (int64_t)r * a.sxl + c0, once);
    };
    auto emit = [&](int r, const R& ux, const R& usc, const R& ush) {
      float xv[W], sc[W], sh[W], y[W];
      unpack<T, W>(ux, xv);
      if (film) {
        unpack<T, W>(usc, sc);
        unpack<T, W>(ush, sh);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        // The plain version's operations, each rounded to f32 (no fused
        // multiply-adds), so that the output rounds to the same bf16.
        float v = __fmul_rn(__fsub_rn(xv[w], mu[w]), rs[w]);
        v = __fadd_rn(__fmul_rn(v, gam[w]), bet[w]);
        if (film) v = __fadd_rn(__fmul_rn(v, __fadd_rn(1.f, sc[w])), sh[w]);
        if (silu) v = __fmul_rn(v, 1.f / (1.f + expf(-v)));
        y[w] = v;
      }
      st_hint<T, W>(on + (int64_t)r * C + c0, pack<T, W>(y), once);
    };
    // NB rows at a time, every load issued before the first store (fewer
    // with FiLM's three loads a row; fewer still with SiLU, where more
    // would spill at 128 registers).
    constexpr int NB = FILM ? (SILU ? 2 : 4) : 8;
    int r = r0 + ry;
    for (; r + (NB - 1) * RY < r1; r += NB * RY) {
      R ux[NB], usc[NB], ush[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        ux[b] = ld_x(r + b * RY);
        usc[b] = ush[b] = ux[b];
        if (film) {
          usc[b] = ld_hint<T, W>(scn + (int64_t)(r + b * RY) * a.ssl + c0,
                                 once);
          ush[b] = ld_hint<T, W>(shn + (int64_t)(r + b * RY) * a.shl + c0,
                                 once);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) emit(r + b * RY, ux[b], usc[b], ush[b]);
    }
    for (; r < r1; r += RY) {
      const R ux = ld_x(r);
      R usc = ux, ush = ux;
      if (film) {
        usc = ld_hint<T, W>(scn + (int64_t)r * a.ssl + c0, once);
        ush = ld_hint<T, W>(shn + (int64_t)r * a.shl + c0, once);
      }
      emit(r, ux, usc, ush);
    }
  }
}

// Shared memory of one forward CTA: the fold buffers, then x of its rows
// when they stay on chip.
template <typename T, int W>
size_t fwd_smem(const GnFwdArgs& a) {
  return (size_t)fwd_aux_doubles(a.C, a.G, W) * sizeof(double) +
         (a.onchip ? (size_t)a.rows_per_cta * a.C * sizeof(T) : 0);
}

// Launch the forward, or, with `max_clusters`, only ask how many of its
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters).
template <typename T, int W, bool FILM, bool SILU>
cudaError_t launch_fwd(const GnFwdArgs& a, int cs, cudaStream_t stream,
                       int* max_clusters) {
  auto kernel = gn_fwd_cluster_kernel<T, W, FILM, SILU>;
  const size_t smem = fwd_smem<T, W>(a);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(kernel, SMEM_MAX, &done, true);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, a.N, FWD_NT, smem, stream);
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &l.cfg);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_fwd_w(const GnFwdArgs& a, int cs, int film, int silu,
                         cudaStream_t stream, int* max_clusters) {
  if constexpr (W == 1) {   // one element kernel for all four modes
    return launch_fwd<T, 1, false, false>(a, cs, stream, max_clusters);
  } else {
    if (film && silu)
      return launch_fwd<T, W, true, true>(a, cs, stream, max_clusters);
    if (film)
      return launch_fwd<T, W, true, false>(a, cs, stream, max_clusters);
    if (silu)
      return launch_fwd<T, W, false, true>(a, cs, stream, max_clusters);
    return launch_fwd<T, W, false, false>(a, cs, stream, max_clusters);
  }
}

template <typename T>
cudaError_t launch_fwd_all(const GnFwdArgs& a, int cs, int film, int silu,
                           cudaStream_t stream, int* max_clusters) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = aligned16(a.x, a.sxn, a.sxl, a.C, W) &&
                   aligned16(a.scale, a.ssn, a.ssl, a.C, W) &&
                   aligned16(a.shift, a.shn, a.shl, a.C, W) &&
                   aligned16(a.out, 0, 0, a.C, W);
  if (vec) return launch_fwd_w<T, W>(a, cs, film, silu, stream, max_clusters);
  return launch_fwd_w<T, 1>(a, cs, film, silu, stream, max_clusters);
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
// What bounds it on an H100: bytes -- ~30 flops per element against
// reading x, g, scale and (under SiLU, the one use of y) shift once and
// writing dx, dscale, dshift once.  At
// the srn64 train step's 64^2 level one bf16 tensor is N * L * C * 2 = 268
// MB, so nothing stays in the 50 MB L2 between two passes over the data.
// Design: one thread-block cluster of CS CTAs per sample n
// (gn_bwd_cluster_kernel), so the whole backward of a sample is one pass:
//   * phase 1: CTA `rank` of the cluster streams its rows [rank * R, ...)
//     of x, g, scale and shift with 16-byte loads (8 bf16 channels a lane,
//     two rows in flight; element loads when a view is not 16-byte
//     aligned), x and g ahead of use by cp.async when they stay on chip,
//     each lane holding its channels' gamma, beta, mean and rstd in
//     registers.  It writes dscale and dshift (they need no group
//     statistics), keeps its rows of x and g in shared memory when the
//     plan says they fit (`onchip`), and sums per channel dxhat, dxhat *
//     x_hat, dy_gn * x_hat and dy_gn;
//   * exchange: per-channel sums fold to groups in shared memory; after
//     cluster.sync() every CTA reads the CS partials of all CTAs through
//     distributed shared memory in rank order, so every CTA gets the same
//     mean_g(dxhat) and mean_g(dxhat * x_hat) (no float atomics: a train
//     step is bit-identical run to run).  The CTAs also fold the per-
//     channel dgamma / dbeta partials over the cluster into [N, C];
//   * phase 2: each CTA writes dx for its rows from the x and g it kept
//     (or re-reads, when they did not fit), re-reading scale (and shift
//     under SiLU).
// Then gn_bwd_param_kernel folds the [N, C] partials over N in a fixed
// order, 32 channels by 16 row groups a block.  When the rows stay on
// chip, HBM traffic is the bound's plus scale (and shift) once more from
// L2.  The host plan (cuda_film.backward_plan) picks CS (1..16), R and
// `onchip` per call from N, L, C and the dtype: on chip only where two
// CTAs still share an SM.  At the 64^2 level the rows fit only at one CTA
// per SM, and clusters of 8 re-reading x and g measured faster.

constexpr int BWD_NT = 256;        // threads of a backward cluster CTA

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
  float* pdg;                      // [N, C] per-sample dgamma partials
  float* pdb;                      // [N, C] per-sample dbeta partials
  int N, L, C, G, rows_per_cta, onchip;
};

// One lane's W channels [c0, c0 + W): gamma, beta and its sample's group
// mean / rstd on each.
template <int W>
struct ChanParams {
  float gam[W], bet[W], mu[W], rs[W];
  __device__ __forceinline__ void load(const GnBwdArgs& a, int n, int c0) {
    const int gs = a.C / a.G;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int c = c0 + w;
      const int64_t grp = (int64_t)n * a.G + c / gs;
      gam[w] = a.gamma[c];
      bet[w] = a.beta[c];
      mu[w] = a.mean[grp];
      rs[w] = a.rstd[grp];
    }
  }
};

// The element chain of one (row, channel): returns x_hat, y_gn, dy_f,
// dy_gn and dxhat from x, g, scale and shift (scale / shift unused without
// FiLM, shift unused without SiLU).
struct GnGrad {
  float xhat, y_gn, dy_f, dy_gn, dxhat;
};

// SiLU's sigmoid takes the hardware exp2 and a fast divide (~2 ulp, far
// inside the f32 tolerance): both phases recompute it for every element,
// and with x and g on chip they are bound by these instructions.
template <bool FILM, bool SILU>
__device__ __forceinline__ GnGrad gn_grad(float x, float g, float sc,
                                          float sh, float gam, float bet,
                                          float mu, float rs) {
  GnGrad o;
  o.xhat = (x - mu) * rs;
  o.y_gn = o.xhat * gam + bet;
  float sc1 = 1.f, y = o.y_gn;
  if (FILM) {
    sc1 = 1.f + sc;
    y = o.y_gn * sc1 + sh;
  }
  if (SILU) {
    const float sig = __fdividef(1.f, 1.f + __expf(-y));
    o.dy_f = g * (sig * (1.f + y * (1.f - sig)));
  } else {
    o.dy_f = g;
  }
  o.dy_gn = FILM ? o.dy_f * sc1 : o.dy_f;
  o.dxhat = o.dy_gn * gam;
  return o;
}

// One row's W channels of every input, as f32.
template <int W>
struct RowIn {
  float x[W], g[W], sc[W], sh[W];
};

template <typename T, int W, bool FILM, bool SILU>
__global__ void __launch_bounds__(BWD_NT, 2)
    gn_bwd_cluster_kernel(GnBwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y, tid = threadIdx.x;
  const int C = a.C, G = a.G, gs = C / G;
  extern __shared__ float4 smem_f4[];
  float* c1 = reinterpret_cast<float*>(smem_f4);   // [C] sum dxhat; then
                                                    // [G] mean_g(dxhat)
  float* c2 = c1 + C;              // [C] sum dxhat * x_hat; then its mean_g
  float* cdg = c2 + C;             // [C] sum dy_gn * x_hat  (read by peers)
  float* cdb = cdg + C;            // [C] sum dy_gn          (read by peers)
  float* s1 = cdb + C;             // [G] group sums of c1   (read by peers)
  float* s2 = s1 + G;              // [G] group sums of c2   (read by peers)
  float* red = s2 + G;             // [BWD_NT][W] fold scratch
  // x then g of this CTA's rows, [R][C] each (16-byte aligned).
  T* xs = reinterpret_cast<T*>(
      reinterpret_cast<float*>(smem_f4) +
      ((4 * C + 2 * G + BWD_NT * W + 3) & ~3));
  T* gsm = xs + (size_t)a.rows_per_cta * C;

  const int r0 = min(a.L, rank * a.rows_per_cta);
  const int r1 = min(a.L, r0 + a.rows_per_cta);
  const bool onchip = a.onchip != 0;
  // Lane layout: SP channel slots of W channels per pass, RY rows in
  // flight; passes over slots [cv0, cv0 + SP) when C / W > BWD_NT.
  const int NV = C / W;
  const int SP = min(NV, BWD_NT), RY = BWD_NT / SP;
  const int sv = tid % SP, ry = tid / SP;
  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn;
  const T* gn = static_cast<const T*>(a.g) + (int64_t)n * a.sgn;
  const T* scn = static_cast<const T*>(a.scale) + (int64_t)n * a.ssn;
  const T* shn = static_cast<const T*>(a.shift) + (int64_t)n * a.shn;
  const int64_t on = (int64_t)n * a.L * C;
  const int rc = (r1 - r0 + NCHUNK - 1) / NCHUNK;   // rows per chunk

  // On chip: every row of x and g into shared memory, chunk by chunk (one
  // commit group each), 16 bytes a copy; element by element when the
  // views are not 16-byte aligned.
  if (onchip) {
    if constexpr (W > 1) {
      const uint32_t sx = (uint32_t)__cvta_generic_to_shared(xs);
      const uint32_t sg = (uint32_t)__cvta_generic_to_shared(gsm);
      for (int q = 0; q < NCHUNK; ++q) {
        const int i0 = q * rc, i1 = min(r1 - r0, i0 + rc);
        for (int e = i0 * NV + tid; e < i1 * NV; e += BWD_NT) {
          const int i = e / NV, c0 = (e % NV) * W;
          const uint32_t off = (uint32_t)(((size_t)i * C + c0) * sizeof(T));
          cp_async16(sx + off, xn + (int64_t)(r0 + i) * a.sxl + c0);
          cp_async16(sg + off, gn + (int64_t)(r0 + i) * a.sgl + c0);
        }
        cp_async_commit();
      }
    } else {
      for (int e = tid; e < (r1 - r0) * C; e += BWD_NT) {
        const int i = e / C, c = e % C;
        xs[(size_t)i * C + c] = xn[(int64_t)(r0 + i) * a.sxl + c];
        gsm[(size_t)i * C + c] = gn[(int64_t)(r0 + i) * a.sgl + c];
      }
      __syncthreads();
    }
  }

  // The inputs of row r at channels [c0, c0 + W) that come from global
  // memory (shift only when `need_sh`: y, and so shift, matters only
  // under SiLU), and x, g from shared memory when they are on chip.
  auto load_global = [&](int r, int c0, RowIn<W>& in, bool need_sh) {
    if (!onchip) {
      load_vec<T, W>(xn + (int64_t)r * a.sxl + c0, in.x);
      load_vec<T, W>(gn + (int64_t)r * a.sgl + c0, in.g);
    }
    if (FILM) {
      load_vec<T, W>(scn + (int64_t)r * a.ssl + c0, in.sc);
      if (need_sh) load_vec<T, W>(shn + (int64_t)r * a.shl + c0, in.sh);
    }
  };
  auto load_onchip = [&](int r, int c0, RowIn<W>& in) {
    if (onchip) {
      const size_t srow = (size_t)(r - r0) * C + c0;
      load_vec<T, W>(xs + srow, in.x);
      load_vec<T, W>(gsm + srow, in.g);
    }
  };
  // Rows rs + ry, rs + ry + RY, ... below re, two at a time: the global
  // loads of both rows are issued before either is used.
  auto for_rows = [&](int rs, int re, int c0, bool need_sh, auto&& body) {
    constexpr int NB = 2;
    int r = rs + ry;
    for (; r + (NB - 1) * RY < re; r += NB * RY) {
      RowIn<W> in[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) load_global(r + b * RY, c0, in[b], need_sh);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        load_onchip(r + b * RY, c0, in[b]);
        body(r + b * RY, in[b]);
      }
    }
    for (; r < re; r += RY) {
      RowIn<W> in;
      load_global(r, c0, in, need_sh);
      load_onchip(r, c0, in);
      body(r, in);
    }
  };

  // Phase 1.
  for (int cv0 = 0; cv0 < NV; cv0 += SP) {
    const int cv = cv0 + sv;
    const bool act = ry < RY && cv < NV;
    const int c0 = cv * W;
    float acc[4][W];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[q][w] = 0.f;
    ChanParams<W> cp;
    if (act) cp.load(a, n, c0);
    auto chain = [&](int r, const RowIn<W>& in) {
      float dsc[W], dsh[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const GnGrad o = gn_grad<FILM, SILU>(in.x[w], in.g[w], in.sc[w],
                                             in.sh[w], cp.gam[w], cp.bet[w],
                                             cp.mu[w], cp.rs[w]);
        acc[0][w] += o.dxhat;
        acc[1][w] += o.dxhat * o.xhat;
        acc[2][w] += o.dy_gn * o.xhat;
        acc[3][w] += o.dy_gn;
        dsc[w] = o.dy_f * o.y_gn;
        dsh[w] = o.dy_f;
      }
      if (FILM) {
        const int64_t orow = on + (int64_t)r * C + c0;
        store_vec<T, W>(static_cast<T*>(a.dscale) + orow, dsc);
        store_vec<T, W>(static_cast<T*>(a.dshift) + orow, dsh);
      }
    };
    if (onchip) {
      for (int q = 0; q < NCHUNK; ++q) {
        if (W > 1 && cv0 == 0) {   // chunk q of the copies has landed
          if (q == 0) cp_async_wait<NCHUNK - 1>();
          else if (q == 1) cp_async_wait<NCHUNK - 2>();
          else if (q == 2) cp_async_wait<NCHUNK - 3>();
          else cp_async_wait<0>();
          __syncthreads();
        }
        const int rs = r0 + q * rc, re = min(r1, rs + rc);
        if (act) for_rows(rs, re, c0, SILU, chain);
      }
    } else if (act) {
      for_rows(r0, r1, c0, SILU, chain);
    }
    // Fold the RY row groups of each channel in order into c1, c2, cdg,
    // cdb: channel j of the pass is summed by thread j.
    float* dst[4] = {c1, c2, cdg, cdb};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __syncthreads();
#pragma unroll
      for (int w = 0; w < W; ++w) red[tid * W + w] = acc[q][w];
      __syncthreads();
      for (int j = tid; j < SP * W; j += BWD_NT) {
        if (cv0 * W + j >= C) continue;
        float t = 0.f;
        for (int k = 0; k < RY; ++k) t += red[j + k * SP * W];
        dst[q][cv0 * W + j] = t;
      }
    }
  }
  __syncthreads();
  for (int gi = tid; gi < G; gi += BWD_NT) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < gs; ++k) {
      t1 += c1[gi * gs + k];
      t2 += c2[gi * gs + k];
    }
    s1[gi] = t1;
    s2[gi] = t2;
  }
  cluster.sync();

  // Exchange, in rank order: every CTA of the cluster sums the same
  // partials in the same order.  All of a thread's remote loads are issued
  // before the sums.
  const float count = (float)a.L * (float)gs;
  for (int gi = tid; gi < G; gi += BWD_NT) {
    float v1[MAX_CLUSTER], v2[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < cs) {
        v1[k] = cluster.map_shared_rank(s1, k)[gi];
        v2[k] = cluster.map_shared_rank(s2, k)[gi];
      }
    }
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < cs) {
        t1 += v1[k];
        t2 += v2[k];
      }
    }
    c1[gi] = t1 / count;
    c2[gi] = t2 / count;
  }
  for (int c = rank * BWD_NT + tid; c < C; c += cs * BWD_NT) {
    float vg[MAX_CLUSTER], vb[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < cs) {
        vg[k] = cluster.map_shared_rank(cdg, k)[c];
        vb[k] = cluster.map_shared_rank(cdb, k)[c];
      }
    }
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < cs) {
        dg += vg[k];
        db += vb[k];
      }
    }
    a.pdg[(int64_t)n * C + c] = dg;
    a.pdb[(int64_t)n * C + c] = db;
  }
  // No CTA leaves (or reuses s1 .. cdb) while a peer still reads them;
  // the group means in c1 / c2 are visible to the whole CTA.
  cluster.sync();

  // Phase 2: dx.
  for (int cv0 = 0; cv0 < NV; cv0 += SP) {
    const int cv = cv0 + sv;
    if (!(ry < RY && cv < NV)) continue;
    const int c0 = cv * W;
    ChanParams<W> cp;
    cp.load(a, n, c0);
    float m1[W], m2[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      m1[w] = c1[(c0 + w) / gs];
      m2[w] = c2[(c0 + w) / gs];
    }
    auto dx_row = [&](int r, const RowIn<W>& in) {
      float dx[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const GnGrad o = gn_grad<FILM, SILU>(
            in.x[w], in.g[w], in.sc[w], (FILM && SILU) ? in.sh[w] : 0.f,
            cp.gam[w], cp.bet[w], cp.mu[w], cp.rs[w]);
        dx[w] = cp.rs[w] * (o.dxhat - m1[w] - o.xhat * m2[w]);
      }
      store_vec<T, W>(static_cast<T*>(a.dx) + on + (int64_t)r * C + c0, dx);
    };
    for_rows(r0, r1, c0, SILU, dx_row);
  }
}

// dgamma / dbeta: block (32 channels, 16 row groups); row group k sums
// samples k, k + 16, ... in order, then the 16 partials fold in order.
__global__ void __launch_bounds__(512) gn_bwd_param_kernel(GnBwdArgs a) {
  __shared__ float rg[16][33], rb[16][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float dg = 0.f, db = 0.f;
  if (c < a.C) {
    for (int k = ty; k < a.N; k += 16) {
      dg += a.pdg[(int64_t)k * a.C + c];
      db += a.pdb[(int64_t)k * a.C + c];
    }
  }
  rg[ty][tx] = dg;
  rb[ty][tx] = db;
  __syncthreads();
  if (ty == 0 && c < a.C) {
    float tg = 0.f, tb = 0.f;
    for (int k = 0; k < 16; ++k) {
      tg += rg[k][tx];
      tb += rb[k][tx];
    }
    a.dgamma[c] = tg;
    a.dbeta[c] = tb;
  }
}

// Shared memory of one cluster CTA: the fold buffers, then x and g of its
// rows when they stay on chip.
template <typename T, int W>
size_t bwd_smem(const GnBwdArgs& a) {
  const size_t aux = (size_t)((4 * a.C + 2 * a.G + BWD_NT * W + 3) & ~3);
  return aux * sizeof(float) +
         (a.onchip ? 2 * (size_t)a.rows_per_cta * a.C * sizeof(T) : 0);
}

template <typename T, int W, bool FILM, bool SILU>
cudaError_t launch_bwd(const GnBwdArgs& a, int cs, cudaStream_t stream) {
  auto kernel = gn_bwd_cluster_kernel<T, W, FILM, SILU>;
  const size_t smem = bwd_smem<T, W>(a);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(kernel, SMEM_MAX, &done, true);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, a.N, BWD_NT, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_param_kernel<<<(a.C + 31) / 32, 512, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_bwd_w(const GnBwdArgs& a, int cs, int film, int silu,
                         cudaStream_t stream) {
  if (film && silu) return launch_bwd<T, W, true, true>(a, cs, stream);
  if (film) return launch_bwd<T, W, true, false>(a, cs, stream);
  if (silu) return launch_bwd<T, W, false, true>(a, cs, stream);
  return launch_bwd<T, W, false, false>(a, cs, stream);
}

template <typename T>
cudaError_t launch_bwd_all(const GnBwdArgs& a, int cs, int film, int silu,
                           cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = aligned16(a.x, a.sxn, a.sxl, a.C, W) &&
                   aligned16(a.g, a.sgn, a.sgl, a.C, W) &&
                   aligned16(a.scale, a.ssn, a.ssl, a.C, W) &&
                   aligned16(a.shift, a.shn, a.shl, a.C, W) &&
                   aligned16(a.dx, 0, 0, a.C, W) &&
                   (!film || (aligned16(a.dscale, 0, 0, a.C, W) &&
                              aligned16(a.dshift, 0, 0, a.C, W)));
  if (vec) return launch_bwd_w<T, W>(a, cs, film, silu, stream);
  return launch_bwd_w<T, 1>(a, cs, film, silu, stream);
}

// ---------------------------------------------------------------------------
// Split statistics (context parallelism).  The same two TPU kernels
// (pallas_film.py::_fwd_kernel and ::_bwd_kernel) when a sample's rows lie
// on several ranks: each pass splits in two around a sum over the ranks
// that the host makes (cuda_film._SplitGroupNormFn).
//   (a) gn_split_sums_kernel: per (n, g) the f64 sums of x and x^2 over
//       this rank's rows -> [2, N, G] f64.
//   (b) gn_split_apply_kernel: from the summed f64 sums, mean / rstd by
//       the cluster forward's own f32 operations (inv_count, E[x^2] -
//       mean^2 clamped at 0, rsqrtf(var + eps)), then its element chain,
//       each operation rounded to f32; also the [2, N, G] mean / rstd.
//   (c) gn_split_bwd_sums_kernel: per (n, g) the f32 sums of dxhat and
//       dxhat * x_hat over this rank's rows -> [2, N, G], and per (n, c)
//       the dgamma / dbeta partials, folded over N by gn_bwd_param_kernel.
//   (d) gn_split_bwd_apply_kernel: dx = rstd (dxhat - mean_g(dxhat) - x_hat
//       mean_g(dxhat x_hat)) from the summed sums, dscale, dshift.
// What bounds them on an H100: bytes, as the cluster kernels (a few flops
// an element).  Design: the simplest that is right.  (a) and (c) give each
// (n, g) one block of SPLIT_NT threads, thread t taking channel t % gs of
// the group on rows t / gs, t / gs + SPLIT_NT / gs, ... (gs <= SPLIT_NT),
// and fold the threads' sums in shared memory in a fixed tree, so a call
// is bit-identical run to run; a group's gs channels are gs * sizeof(T)
// contiguous bytes of a row, so narrow groups read whole sectors only in
// part.  (b) and (d) are grid-stride element loops that read each
// element's group statistics again (from L1).  No float atomics, no
// scratch beyond (c)'s [2, N, C] partials; nothing synchronises.

constexpr int SPLIT_NT = 256;      // threads of a split-sums block

struct GnSplitArgs {
  const void* x;
  long long sxn, sxl;
  const void* g;                   // (c), (d): the upstream gradient
  long long sgn, sgl;
  const float* gamma;
  const float* beta;
  const void* scale;
  long long ssn, ssl;
  const void* shift;
  long long shn, shl;
  const double* sums;              // (b): [2, N, G] summed over the ranks
  double* psums;                   // (a): [2, N, G] this rank's
  const float* stats;              // (c), (d): [2, N, G] mean, rstd
  float* stats_out;                // (b)
  const float* bsums;              // (d): [2, N, G] summed over the ranks
  float* bpsums;                   // (c): [2, N, G] this rank's
  void* out;                       // (b): out, (d): dx; contiguous
  void* dscale;                    // (d), FiLM only; contiguous
  void* dshift;
  float* pdg;                      // (c): [N, C] dgamma partials
  float* pdb;                      // (c): [N, C] dbeta partials
  int N, L, Ltot, C, G;            // Ltot: the whole image's L
  float eps;
};

// Fold v[SPLIT_NT] in a fixed tree; the total lands in v[0].
template <typename A>
__device__ __forceinline__ void block_fold(A* v) {
  for (int s = SPLIT_NT / 2; s > 0; s >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < s) v[threadIdx.x] += v[threadIdx.x + s];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_NT)
    gn_split_sums_kernel(GnSplitArgs a) {
  __shared__ double r1[SPLIT_NT], r2[SPLIT_NT];
  const int gi = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int gs = a.C / a.G, RY = SPLIT_NT / gs;
  const int ch = tid % gs, ry = tid / gs;
  const T* xn = static_cast<const T*>(a.x) + (int64_t)n * a.sxn +
                (int64_t)gi * gs + ch;
  double s = 0.0, q = 0.0;
  if (ry < RY) {
    for (int r = ry; r < a.L; r += RY) {
      const double v = load_f32<T>(xn + (int64_t)r * a.sxl);
      s += v;
      q += v * v;
    }
  }
  r1[tid] = s;
  r2[tid] = q;
  block_fold(r1);
  block_fold(r2);
  if (tid == 0) {
    a.psums[(int64_t)n * a.G + gi] = r1[0];
    a.psums[((int64_t)a.N + n) * a.G + gi] = r2[0];
  }
}

// The cluster forward's statistics from the sums of a group.
__device__ __forceinline__ void split_stats(double t1, double t2,
                                            float inv_count, float eps,
                                            float& mean, float& rstd) {
  mean = __fmul_rn((float)t1, inv_count);
  const float mean2 = __fmul_rn((float)t2, inv_count);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  rstd = rsqrtf(__fadd_rn(var, eps));
}

template <typename T, bool FILM, bool SILU>
__global__ void __launch_bounds__(256) gn_split_apply_kernel(GnSplitArgs a) {
  const int C = a.C, G = a.G, gs = C / G;
  const float inv_count = 1.f / ((float)a.Ltot * (float)gs);
  const int64_t total = (int64_t)a.N * a.L * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % C);
    const int64_t nr = e / C;
    const int r = (int)(nr % a.L), n = (int)(nr / a.L);
    const int64_t grp = (int64_t)n * G + c / gs;
    float mu, rs;
    split_stats(a.sums[grp], a.sums[(int64_t)a.N * G + grp], inv_count,
                a.eps, mu, rs);
    if (r == 0 && c % gs == 0) {
      a.stats_out[grp] = mu;
      a.stats_out[(int64_t)a.N * G + grp] = rs;
    }
    const float xv = load_f32<T>(static_cast<const T*>(a.x) +
                                 (int64_t)n * a.sxn + (int64_t)r * a.sxl + c);
    // The cluster kernel's operations, each rounded to f32.
    float v = __fmul_rn(__fsub_rn(xv, mu), rs);
    v = __fadd_rn(__fmul_rn(v, a.gamma[c]), a.beta[c]);
    if (FILM) {
      const float sc = load_f32<T>(static_cast<const T*>(a.scale) +
                                   (int64_t)n * a.ssn + (int64_t)r * a.ssl +
                                   c);
      const float sh = load_f32<T>(static_cast<const T*>(a.shift) +
                                   (int64_t)n * a.shn + (int64_t)r * a.shl +
                                   c);
      v = __fadd_rn(__fmul_rn(v, __fadd_rn(1.f, sc)), sh);
    }
    if (SILU) v = __fmul_rn(v, 1.f / (1.f + expf(-v)));
    static_cast<T*>(a.out)[e] = from_f32<T>(v);
  }
}

// One element's backward chain (gn_grad) at (n, r, c).
template <typename T, bool FILM, bool SILU>
__device__ __forceinline__ GnGrad split_grad(const GnSplitArgs& a, int n,
                                             int r, int c, float mu,
                                             float rs) {
  const int64_t xo = (int64_t)n * a.sxn + (int64_t)r * a.sxl + c;
  const int64_t go = (int64_t)n * a.sgn + (int64_t)r * a.sgl + c;
  const float xv = load_f32<T>(static_cast<const T*>(a.x) + xo);
  const float gv = load_f32<T>(static_cast<const T*>(a.g) + go);
  float sc = 0.f, sh = 0.f;
  if (FILM) {
    sc = load_f32<T>(static_cast<const T*>(a.scale) + (int64_t)n * a.ssn +
                     (int64_t)r * a.ssl + c);
    if (SILU)
      sh = load_f32<T>(static_cast<const T*>(a.shift) + (int64_t)n * a.shn +
                       (int64_t)r * a.shl + c);
  }
  return gn_grad<FILM, SILU>(xv, gv, sc, sh, a.gamma[c], a.beta[c], mu, rs);
}

template <typename T, bool FILM, bool SILU>
__global__ void __launch_bounds__(SPLIT_NT)
    gn_split_bwd_sums_kernel(GnSplitArgs a) {
  __shared__ float r1[SPLIT_NT], r2[SPLIT_NT], r3[SPLIT_NT], r4[SPLIT_NT];
  const int gi = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int gs = a.C / a.G, RY = SPLIT_NT / gs;
  const int ch = tid % gs, ry = tid / gs, c = gi * gs + ch;
  const int64_t grp = (int64_t)n * a.G + gi;
  const float mu = a.stats[grp], rs = a.stats[(int64_t)a.N * a.G + grp];
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
  if (ry < RY) {
    for (int r = ry; r < a.L; r += RY) {
      const GnGrad o = split_grad<T, FILM, SILU>(a, n, r, c, mu, rs);
      s1 += o.dxhat;
      s2 += o.dxhat * o.xhat;
      s3 += o.dy_gn * o.xhat;
      s4 += o.dy_gn;
    }
  }
  r1[tid] = s1;
  r2[tid] = s2;
  r3[tid] = s3;
  r4[tid] = s4;
  __syncthreads();
  // Per channel: its RY row groups in order (before the group folds
  // overwrite nothing of r3 / r4).
  if (tid < gs) {
    float dg = 0.f, db = 0.f;
    for (int k = 0; k < RY; ++k) {
      dg += r3[tid + k * gs];
      db += r4[tid + k * gs];
    }
    a.pdg[(int64_t)n * a.C + c] = dg;
    a.pdb[(int64_t)n * a.C + c] = db;
  }
  block_fold(r1);
  block_fold(r2);
  if (tid == 0) {
    a.bpsums[grp] = r1[0];
    a.bpsums[(int64_t)a.N * a.G + grp] = r2[0];
  }
}

template <typename T, bool FILM, bool SILU>
__global__ void __launch_bounds__(256)
    gn_split_bwd_apply_kernel(GnSplitArgs a) {
  const int C = a.C, G = a.G, gs = C / G;
  const float count = (float)a.Ltot * (float)gs;
  const int64_t total = (int64_t)a.N * a.L * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % C);
    const int64_t nr = e / C;
    const int r = (int)(nr % a.L), n = (int)(nr / a.L);
    const int64_t grp = (int64_t)n * G + c / gs;
    const int64_t grp2 = (int64_t)a.N * G + grp;
    const float rs = a.stats[grp2];
    const GnGrad o = split_grad<T, FILM, SILU>(a, n, r, c, a.stats[grp], rs);
    const float m1 = a.bsums[grp] / count, m2 = a.bsums[grp2] / count;
    static_cast<T*>(a.out)[e] = from_f32<T>(rs * (o.dxhat - m1 - o.xhat * m2));
    if (FILM) {
      static_cast<T*>(a.dscale)[e] = from_f32<T>(o.dy_f * o.y_gn);
      static_cast<T*>(a.dshift)[e] = from_f32<T>(o.dy_f);
    }
  }
}

// Blocks of an element kernel: enough for the card, the rest by the
// grid-stride loop.
int split_blocks(const GnSplitArgs& a) {
  const long long total = (long long)a.N * a.L * a.C;
  const long long b = (total + 255) / 256;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// The four modes of a template kernel launcher K<T, FILM, SILU>.
#define SPLIT_MODES(KERNEL, T, FILM_, SILU_, GRID, BLOCK, STREAM, A)       \
  do {                                                                     \
    if (FILM_ && SILU_)                                                    \
      KERNEL<T, true, true><<<GRID, BLOCK, 0, STREAM>>>(A);                \
    else if (FILM_)                                                        \
      KERNEL<T, true, false><<<GRID, BLOCK, 0, STREAM>>>(A);               \
    else if (SILU_)                                                        \
      KERNEL<T, false, true><<<GRID, BLOCK, 0, STREAM>>>(A);               \
    else                                                                   \
      KERNEL<T, false, false><<<GRID, BLOCK, 0, STREAM>>>(A);              \
  } while (0)

bool split_ok(int N, int L, int C, int G, int dtype) {
  return N >= 1 && L >= 1 && C >= 1 && G >= 1 && C % G == 0 &&
         C / G <= SPLIT_NT && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, scale, shift and out share it).
// out: contiguous [N, L, C].  stats: float [2, N, G] (per-group mean, then
// rstd) written when not null -- the residual of the backward
// (save_stats).  cluster: CTAs per sample (1..16), each taking
// rows_per_cta rows (cluster * rows_per_cta >= L); onchip: they keep those
// rows of x in shared memory.  Returns a cudaError_t code.
int gn_fused_forward(const void* x, long long sxn, long long sxl,
                     const void* gamma, const void* beta,
                     const void* scale, long long ssn, long long ssl,
                     const void* shift, long long shn, long long shl,
                     void* out, void* stats, int N, int L, int C, int G,
                     int cluster, int rows_per_cta, int onchip, int dtype,
                     int film, int silu, float eps, void* stream) {
  if (N < 1 || L < 1 || C < 1 || G < 1 || C % G != 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || rows_per_cta < 1 ||
      (long long)cluster * rows_per_cta < L || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  GnFwdArgs a;
  a.x = x;
  a.sxn = sxn;
  a.sxl = sxl;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.scale = film ? scale : x;
  a.ssn = film ? ssn : sxn;
  a.ssl = film ? ssl : sxl;
  a.shift = film ? shift : x;
  a.shn = film ? shn : sxn;
  a.shl = film ? shl : sxl;
  a.out = out;
  a.stats = static_cast<float*>(stats);
  a.N = N;
  a.L = L;
  a.C = C;
  a.G = G;
  a.rows_per_cta = rows_per_cta;
  a.onchip = onchip != 0;
  a.film = film != 0;
  a.silu = silu != 0;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch_fwd_all<float>(a, cluster, film, silu, st, nullptr)
          : launch_fwd_all<__nv_bfloat16>(a, cluster, film, silu, st,
                                          nullptr);
  return (int)err;
}

// How many clusters of gn_fused_forward's kernel for this plan the card
// holds at once (cudaOccupancyMaxActiveClusters; 0: it cannot launch),
// into *out.  vec: the 16-byte-lane kernel (else the element one).
int gn_forward_max_clusters(int L, int C, int G, int cluster,
                            int rows_per_cta, int onchip, int dtype,
                            int film, int silu, int vec, int* out) {
  if (L < 1 || C < 1 || G < 1 || C % G != 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || rows_per_cta < 1 || out == nullptr ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  GnFwdArgs a = {};
  a.N = 1;
  a.L = L;
  a.C = C;
  a.G = G;
  a.rows_per_cta = rows_per_cta;
  a.onchip = onchip != 0;
  a.film = film != 0;
  a.silu = silu != 0;
  cudaError_t err;
  if (dtype == 0)
    err = vec ? launch_fwd_w<float, 4>(a, cluster, film, silu, 0, out)
              : launch_fwd_w<float, 1>(a, cluster, film, silu, 0, out);
  else
    err = vec ? launch_fwd_w<__nv_bfloat16, 8>(a, cluster, film, silu, 0, out)
              : launch_fwd_w<__nv_bfloat16, 1>(a, cluster, film, silu, 0,
                                               out);
  return (int)err;
}

// Backward of gn_fused_forward.  stats: the forward's float [2, N, G]
// (mean, rstd).  dx (and dscale / dshift with FiLM) are contiguous
// [N, L, C] of dtype; dgamma / dbeta float [C].  partial: float scratch of
// 2 * N * C.  cluster: CTAs per sample (1..16), each taking rows_per_cta
// rows (cluster * rows_per_cta >= L); onchip: they keep those rows of x
// and g in shared memory.  Returns a cudaError_t code.
int gn_fused_backward(const void* x, long long sxn, long long sxl,
                      const void* g, long long sgn, long long sgl,
                      const void* gamma, const void* beta,
                      const void* scale, long long ssn, long long ssl,
                      const void* shift, long long shn, long long shl,
                      const void* stats, void* dx, void* dscale,
                      void* dshift, void* dgamma, void* dbeta,
                      void* partial, int N, int L, int C, int G, int cluster,
                      int rows_per_cta, int onchip, int dtype, int film,
                      int silu, void* stream) {
  if (N < 1 || L < 1 || C < 1 || G < 1 || C % G != 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || rows_per_cta < 1 ||
      (long long)cluster * rows_per_cta < L || (dtype != 0 && dtype != 1) ||
      stats == nullptr || (film && (dscale == nullptr || dshift == nullptr)))
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
  a.dscale = film ? dscale : dx;
  a.dshift = film ? dshift : dx;
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.pdg = static_cast<float*>(partial);
  a.pdb = a.pdg + (size_t)N * C;
  a.N = N;
  a.L = L;
  a.C = C;
  a.G = G;
  a.rows_per_cta = rows_per_cta;
  a.onchip = onchip != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_bwd_all<float>(a, cluster, film, silu, st)
                 : launch_bwd_all<__nv_bfloat16>(a, cluster, film, silu, st);
  return (int)err;
}

// ---- split statistics (context parallelism) --------------------------------
// dtype: 0 = float32, 1 = bfloat16 (x, g, scale, shift and the outputs
// share it).  Views take element strides (sxn, sxl) with unit channel
// stride; outputs are contiguous [N, L, C].  Ltot: the whole image's L
// (every rank's rows), the count each group's mean divides by over C / G.
// At most 256 channels a group.  Each returns a cudaError_t code.

// (a) psums: double [2, N, G], the sums of x and x^2 over these rows.
int gn_split_sums(const void* x, long long sxn, long long sxl, void* psums,
                  int N, int L, int C, int G, int dtype, void* stream) {
  if (!split_ok(N, L, C, G, dtype) || psums == nullptr)
    return (int)cudaErrorInvalidValue;
  GnSplitArgs a = {};
  a.x = x;
  a.sxn = sxn;
  a.sxl = sxl;
  a.psums = static_cast<double*>(psums);
  a.N = N;
  a.L = L;
  a.C = C;
  a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, N);
  if (dtype == 0)
    gn_split_sums_kernel<float><<<grid, SPLIT_NT, 0, st>>>(a);
  else
    gn_split_sums_kernel<__nv_bfloat16><<<grid, SPLIT_NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// (b) sums: double [2, N, G] over every rank; out like x; stats: float
// [2, N, G] mean, rstd.
int gn_split_apply(const void* x, long long sxn, long long sxl,
                   const void* gamma, const void* beta, const void* scale,
                   long long ssn, long long ssl, const void* shift,
                   long long shn, long long shl, const void* sums, void* out,
                   void* stats, int N, int L, int Ltot, int C, int G,
                   int dtype, int film, int silu, float eps, void* stream) {
  if (!split_ok(N, L, C, G, dtype) || Ltot < L || sums == nullptr ||
      out == nullptr || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  GnSplitArgs a = {};
  a.x = x;
  a.sxn = sxn;
  a.sxl = sxl;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.scale = film ? scale : x;
  a.ssn = film ? ssn : sxn;
  a.ssl = film ? ssl : sxl;
  a.shift = film ? shift : x;
  a.shn = film ? shn : sxn;
  a.shl = film ? shl : sxl;
  a.sums = static_cast<const double*>(sums);
  a.out = out;
  a.stats_out = static_cast<float*>(stats);
  a.N = N;
  a.L = L;
  a.Ltot = Ltot;
  a.C = C;
  a.G = G;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = split_blocks(a);
  if (dtype == 0)
    SPLIT_MODES(gn_split_apply_kernel, float, film, silu, blocks, 256, st, a);
  else
    SPLIT_MODES(gn_split_apply_kernel, __nv_bfloat16, film, silu, blocks, 256,
                st, a);
  return (int)cudaGetLastError();
}

// (c) stats: the forward's float [2, N, G]; bpsums: float [2, N, G], the
// sums of dxhat and dxhat * x_hat over these rows; partial: float scratch
// of 2 * N * C; dgamma / dbeta: float [C], this rank's.
int gn_split_backward_sums(const void* x, long long sxn, long long sxl,
                           const void* g, long long sgn, long long sgl,
                           const void* gamma, const void* beta,
                           const void* scale, long long ssn, long long ssl,
                           const void* shift, long long shn, long long shl,
                           const void* stats, void* bpsums, void* partial,
                           void* dgamma, void* dbeta, int N, int L, int C,
                           int G, int dtype, int film, int silu,
                           void* stream) {
  if (!split_ok(N, L, C, G, dtype) || stats == nullptr ||
      bpsums == nullptr || partial == nullptr || dgamma == nullptr ||
      dbeta == nullptr)
    return (int)cudaErrorInvalidValue;
  GnSplitArgs a = {};
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
  a.stats = static_cast<const float*>(stats);
  a.bpsums = static_cast<float*>(bpsums);
  a.pdg = static_cast<float*>(partial);
  a.pdb = a.pdg + (size_t)N * C;
  a.N = N;
  a.L = L;
  a.C = C;
  a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, N);
  if (dtype == 0)
    SPLIT_MODES(gn_split_bwd_sums_kernel, float, film, silu, grid, SPLIT_NT,
                st, a);
  else
    SPLIT_MODES(gn_split_bwd_sums_kernel, __nv_bfloat16, film, silu, grid,
                SPLIT_NT, st, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  GnBwdArgs pa = {};
  pa.pdg = a.pdg;
  pa.pdb = a.pdb;
  pa.dgamma = static_cast<float*>(dgamma);
  pa.dbeta = static_cast<float*>(dbeta);
  pa.N = N;
  pa.C = C;
  gn_bwd_param_kernel<<<(C + 31) / 32, 512, 0, st>>>(pa);
  return (int)cudaGetLastError();
}

// (d) stats: the forward's float [2, N, G]; bsums: float [2, N, G] over
// every rank; dx (and dscale / dshift with FiLM) like x.
int gn_split_backward_apply(const void* x, long long sxn, long long sxl,
                            const void* g, long long sgn, long long sgl,
                            const void* gamma, const void* beta,
                            const void* scale, long long ssn, long long ssl,
                            const void* shift, long long shn, long long shl,
                            const void* stats, const void* bsums, void* dx,
                            void* dscale, void* dshift, int N, int L,
                            int Ltot, int C, int G, int dtype, int film,
                            int silu, void* stream) {
  if (!split_ok(N, L, C, G, dtype) || Ltot < L || stats == nullptr ||
      bsums == nullptr || dx == nullptr ||
      (film && (dscale == nullptr || dshift == nullptr)))
    return (int)cudaErrorInvalidValue;
  GnSplitArgs a = {};
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
  a.stats = static_cast<const float*>(stats);
  a.bsums = static_cast<const float*>(bsums);
  a.out = dx;
  a.dscale = film ? dscale : dx;
  a.dshift = film ? dshift : dx;
  a.N = N;
  a.L = L;
  a.Ltot = Ltot;
  a.C = C;
  a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = split_blocks(a);
  if (dtype == 0)
    SPLIT_MODES(gn_split_bwd_apply_kernel, float, film, silu, blocks, 256, st,
                a);
  else
    SPLIT_MODES(gn_split_bwd_apply_kernel, __nv_bfloat16, film, silu, blocks,
                256, st, a);
  return (int)cudaGetLastError();
}

const char* gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
