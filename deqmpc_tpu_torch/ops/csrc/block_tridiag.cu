// Batched block-tridiagonal SPD solve H x = b for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_solve_kernel`
// (deqmpc_tpu/ops/pallas_tridiag.py:100-129), launched there by
// `_pallas_solve_lanes` behind `pallas_block_tridiag_solve`. It computes
// the same function, not a block-by-block copy: the TPU kernel put the
// batch in 128-wide vector lanes and padded the batch with identity
// blocks; here each sample has its own warp.
//
//   D (bsz, T, n, n) diagonal blocks, only the lower triangle read,
//   O (bsz, T-1, n, n) with H[t, t+1] = O[t], b (bsz, T, n)
//   ->  x (bsz, T, n), all row-major.
//   Ld_t Ld_t' = D_t - M_t M_t',   M_t = O_{t-1}' Ld_{t-1}^{-T}
//   y_t = Ld_t^{-1} (b_t - M_t y_{t-1}),  x_t = Ld_t^{-T} (y_t - M_{t+1}' x_{t+1})
//
// What bounds it on this card: latency. The lower triangles of D, O and b
// read once and x written once are 7.6 MB at bsz 1024, T 5, n 16 in f32
// (2.3 us at 3.35 TB/s), and the flops about 2.3 n^3 per block (0.7 us
// at 67 TFLOP/s there), but each sample is a chain of T block steps, and
// each step is a chain of n dependent pivots (reciprocal square root,
// broadcast, update) plus two triangular solves of n dependent steps each. The time of one sample's
// chain is the kernel's time at any batch that fits on the card at once.
//
// Two kernels, one function:
//
// * `bt_warp_kernel` (n <= 32, every block size of the JAX package's envs;
//   the largest is 18): one warp per sample, lane i owns row i.
//   - The Cholesky column steps, the triangular solve for M_t (n right-hand
//     sides: lane j owns column j of Ld_{t-1}^{-1} O_{t-1}, which is row j
//     of M_t) and both sweeps run in registers and warp shuffles. The only
//     synchronisation is __syncwarp: there is no block barrier, so a CTA
//     holds up to 4 independent samples, and a warp without a sample
//     leaves at once.
//   - Every loop runs over a compile-time NP >= n (4, 8, 16, 24 or 32): the
//     block is padded with identity rows, so the chain is straight-line
//     code with no branch on n, and the per-lane rows stay in registers.
//   - The chain stays out of device memory: M_t' is published in the
//     warp's shared memory for S = D_t - M_t M_t' (16-byte broadcast
//     reads); Ld_t, M_t', 1/diag(Ld_t) and y_t stay in the warp's shared
//     memory for the backward sweep while all T blocks fit (else in device
//     scratch that the wrapper allocates); y never goes through x.
//   - D_t (lower triangle), O_{t-1} and b_t are prefetched two blocks ahead
//     into a two-stage ring in the warp's shared memory with cp.async,
//     16 bytes a lane where the rows allow it; neighbouring lanes copy
//     neighbouring addresses. After block 0 no read of D, O or b sits on
//     the chain.
//   - Each pivot takes one reciprocal square root; the next pivot is
//     shuffled before the rest of the column's update; the forward sweep
//     of block t-1 runs beside the Cholesky of block t, which does not
//     depend on it.
//   - No tensor cores: the products are n x n x n with n <= 18 on every
//     path, far below a 64-row `wgmma` tile, and the time is the dependent
//     chain, not the flops. f32 stays full f32 (no TF32), as the JAX solver
//     runs under default_matmul_precision("highest").
//   - nvcc -Xptxas -v (CUDA 12.8, sm_90a), registers per thread and spill
//     stores: NP 16 f32 166, none; NP 16 f64 238, none; NP 32 f32 255,
//     100 bytes; NP 32 f64 255, 252 bytes. Only n > 24 spills, and no env
//     has such blocks.
// * `block_tridiag_solve_kernel` (any n; taken for n > 32, which no env
//   reaches): one thread block per sample with block barriers, the first
//   design, kept as it was and exported on its own (`bt_block_solve_*`)
//   so that it can be timed beside the warp kernel.
//
// A pivot that is not positive (or NaN) gives NaN, never a clamped value,
// so a block that is not SPD turns its whole sample into NaN, as
// `lax.linalg.cholesky` does, and leaves the other samples alone.
//
// Binding: a plain C interface loaded with ctypes; no PyTorch headers.
// The launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__device__ __forceinline__ T pivot_root(T s) {
  return s > T(0) ? sqrt(s) : quiet_nan<T>();
}

// 1/sqrt of a pivot, or NaN for a pivot that is not positive
__device__ __forceinline__ float pivot_rsqrt(float s) {
  return s > 0.0f ? rsqrtf(s) : quiet_nan<float>();
}
__device__ __forceinline__ double pivot_rsqrt(double s) {
  return s > 0.0 ? rsqrt(s) : quiet_nan<double>();
}

// ===================== the block kernel (any n) ==========================

// Shared memory, in elements of T: a vector of n, then either all T
// factors and all T M blocks (all_in_smem) or one working block of each.
__host__ __device__ inline size_t smem_elems(int T, int n, int all_in_smem) {
  const size_t nn = static_cast<size_t>(n) * n;
  return static_cast<size_t>(n) + (all_in_smem ? 2 * static_cast<size_t>(T) * nn : 2 * nn);
}

template <typename T>
__global__ void block_tridiag_solve_kernel(const T* __restrict__ D, const T* __restrict__ O,
                                           const T* __restrict__ b, T* x, T* scratch, int Tn,
                                           int n, int all_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nn = n * n;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const long long s = blockIdx.x;

  D += s * Tn * nn;
  O += s * (Tn > 1 ? Tn - 1 : 0) * nn;
  b += s * Tn * n;
  x += s * Tn * n;

  T* vec = smem;
  T* Lbase;  // Ld_0 .. Ld_{T-1}, n*n each (shared or device memory)
  T* Mbase;  // M_0 .. M_{T-1}; M_0 is never read
  T* wL = nullptr;
  T* wM = nullptr;
  if (all_in_smem) {
    Lbase = smem + n;
    Mbase = Lbase + static_cast<size_t>(Tn) * nn;
  } else {
    wL = smem + n;
    wM = wL + nn;
    Lbase = scratch + s * 2 * Tn * nn;
    Mbase = Lbase + static_cast<size_t>(Tn) * nn;
  }

  // ---- factorization, with the forward sweep folded in ----
  for (int t = 0; t < Tn; ++t) {
    T* L = all_in_smem ? Lbase + static_cast<size_t>(t) * nn : wL;
    T* M = all_in_smem ? Mbase + static_cast<size_t>(t) * nn : wM;
    const T* Dt = D + static_cast<size_t>(t) * nn;

    if (t > 0) {
      // X = Ld_{t-1}^{-1} O_{t-1}, one column per thread; M_t = X' (row j of
      // M_t is column j of X). In the scratch layout wL still holds Ld_{t-1}.
      const T* Lp = all_in_smem ? Lbase + static_cast<size_t>(t - 1) * nn : wL;
      const T* Op = O + static_cast<size_t>(t - 1) * nn;
      for (int j = tid; j < n; j += nth) {
        for (int i = 0; i < n; ++i) {
          T acc = Op[i * n + j];
          for (int k = 0; k < i; ++k) acc -= Lp[i * n + k] * M[j * n + k];
          M[j * n + i] = acc / Lp[i * n + i];
        }
      }
      __syncthreads();
    }

    // S = D_t - M_t M_t' (lower triangle), written where Ld_t will live
    for (int e = tid; e < nn; e += nth) {
      const int i = e / n;
      const int k = e - i * n;
      if (k <= i) {
        T acc = Dt[e];
        if (t > 0) {
          for (int l = 0; l < n; ++l) acc -= M[i * n + l] * M[k * n + l];
        }
        L[e] = acc;
      }
    }
    __syncthreads();

    // right-looking Cholesky of S in place (lower triangle only)
    for (int j = 0; j < n; ++j) {
      const T d = pivot_root(L[j * n + j]);
      __syncthreads();  // every thread has read the pivot before it changes
      for (int i = j + tid; i < n; i += nth) L[i * n + j] = (i == j) ? d : L[i * n + j] / d;
      __syncthreads();
      const int m = n - j - 1;
      for (int e = tid; e < m * m; e += nth) {
        const int i = j + 1 + e / m;
        const int k = j + 1 + e % m;
        if (k <= i) L[i * n + k] -= L[i * n + j] * L[k * n + j];
      }
      __syncthreads();
    }

    // forward sweep: y_t = Ld_t^{-1} (b_t - M_t y_{t-1}); y_{t-1} is in x
    for (int i = tid; i < n; i += nth) {
      T acc = b[t * n + i];
      if (t > 0) {
        const T* yp = x + (t - 1) * n;
        for (int l = 0; l < n; ++l) acc -= M[i * n + l] * yp[l];
      }
      vec[i] = acc;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (tid == 0) vec[i] /= L[i * n + i];
      __syncthreads();
      for (int k = i + 1 + tid; k < n; k += nth) vec[k] -= L[k * n + i] * vec[i];
      __syncthreads();
    }
    for (int i = tid; i < n; i += nth) x[t * n + i] = vec[i];
    if (!all_in_smem) {
      T* Lg = Lbase + static_cast<size_t>(t) * nn;
      T* Mg = Mbase + static_cast<size_t>(t) * nn;
      for (int e = tid; e < nn; e += nth) {
        Lg[e] = wL[e];
        Mg[e] = wM[e];
      }
    }
    __syncthreads();
  }

  // ---- backward sweep: x_t = Ld_t^{-T} (y_t - M_{t+1}' x_{t+1}) ----
  for (int t = Tn - 1; t >= 0; --t) {
    const T* L = Lbase + static_cast<size_t>(t) * nn;
    for (int i = tid; i < n; i += nth) {
      T acc = x[t * n + i];
      if (t < Tn - 1) {
        const T* Mn = Mbase + static_cast<size_t>(t + 1) * nn;
        const T* xn = x + (t + 1) * n;
        for (int l = 0; l < n; ++l) acc -= Mn[l * n + i] * xn[l];
      }
      vec[i] = acc;
    }
    __syncthreads();
    for (int i = n - 1; i >= 0; --i) {
      if (tid == 0) vec[i] /= L[i * n + i];
      __syncthreads();
      for (int k = tid; k < i; k += nth) vec[k] -= L[i * n + k] * vec[i];
      __syncthreads();
    }
    for (int i = tid; i < n; i += nth) x[t * n + i] = vec[i];
    __syncthreads();
  }
}

template <typename T>
int launch_block(const T* D, const T* O, const T* b, T* x, T* scratch, int bsz, int Tn, int n,
                 int all_in_smem, void* stream) {
  if (bsz <= 0 || Tn <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!all_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_elems(Tn, n, all_in_smem) * sizeof(T);
  int threads = ((n * n + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(block_tridiag_solve_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  block_tridiag_solve_kernel<T><<<bsz, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, O, b, x, scratch, Tn, n, all_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// ===================== the warp kernel (n <= 32) =========================

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;  // samples per CTA at most

// The compile-time width a block of size n is padded to: every lane loop
// runs over NP rows with no guard on n, so the chain is straight-line code.
// Padded rows and columns hold the identity in D and zeros in O and b;
// they change no real entry and their part of x is never written.
__host__ __device__ inline int padded_n(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : n <= 24 ? 24 : 32;
}
// Row stride of the kept Ld_t: odd, so that lanes walking a column (lane i
// at row i) hit 32 different banks.
__host__ __device__ inline int warp_ld(int n) { return n | 1; }
__host__ __device__ inline size_t round4(size_t e) { return (e + 3) & ~static_cast<size_t>(3); }
// One prefetch stage, padded to NP: D_t (NP rows, stride NP+1 for element
// copies or NP + 16 bytes for 16-byte copies; lower triangle), O_{t-1}
// (NP x NP) and b_t (NP). The padding is written once, before the first
// copy, and no copy touches it. Every region starts 16-byte aligned.
__host__ __device__ inline size_t stage_o_offset(int n) {
  const size_t np = padded_n(n);
  return np * (np + 4);
}
__host__ __device__ inline size_t stage_b_offset(int n) {
  const size_t np = padded_n(n);
  return stage_o_offset(n) + np * np;
}
__host__ __device__ inline size_t stage_elems(int n) { return stage_b_offset(n) + padded_n(n); }
// What the backward sweep keeps of block t: Ld_t (strictly lower rows),
// M_t' padded to NP x NP (row l holds column l of M_t), y_t, 1/diag(Ld_t).
__host__ __device__ inline size_t kept_elems(int n) {
  const size_t np = padded_n(n);
  return round4(static_cast<size_t>(n) * warp_ld(n)) + np * np + round4(2 * static_cast<size_t>(n));
}
__host__ __device__ inline size_t kept_mt_offset(int n) {
  return round4(static_cast<size_t>(n) * warp_ld(n));
}
__host__ __device__ inline size_t kept_y_offset(int n) {
  const size_t np = padded_n(n);
  return kept_mt_offset(n) + np * np;
}
// Shared memory of one warp: the two stages, then all T kept blocks
// (all_in_smem) or one working M_t' (the kept blocks go to scratch).
__host__ __device__ inline size_t warp_smem_elems(int T, int n, int all_in_smem) {
  const size_t np = padded_n(n);
  return 2 * stage_elems(n) + (all_in_smem ? static_cast<size_t>(T) * kept_elems(n) : np * np);
}

template <typename T>
struct Vec16;  // 16 bytes of T, for broadcast loads of M_t'
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int width = 4;
  __device__ static float get(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int width = 2;
  __device__ static double get(const double2& v, int c) { return c == 0 ? v.x : v.y; }
};

template <typename T>
__device__ __forceinline__ void cp_async_16(T* smem_dst, const T* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem_dst, const T* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src),
               "n"(sizeof(T))
               : "memory");
}

// Start the copies of stage t (nothing when t >= T) and commit them as one
// group, so that every lane commits one group per stage. Neighbouring
// lanes copy neighbouring addresses. Where a row of n elements is a whole
// number of 16-byte chunks (vec), each lane copies 16 bytes at a time: the
// chunks of D's rows that hold a lower-triangle element, O's rows and b.
// Otherwise each lane copies one element at a time: D's lower triangle in
// packed order (the lane's first element (i0, k0), then every 32nd), O in
// row-major order and b.
template <typename T, int NP>
__device__ __forceinline__ void prefetch_stage(T* st, const T* D, const T* O, const T* b, int t,
                                               int Tn, int n, int ldd, bool vec, int lane, int i0,
                                               int k0) {
  if (t < Tn) {
    T* Ds = st;
    T* Os = st + stage_o_offset(n);
    T* bs = st + stage_b_offset(n);
    const T* Dt = D + static_cast<size_t>(t) * n * n;
    const T* Ot = O + static_cast<size_t>(t > 0 ? t - 1 : 0) * n * n;
    const T* bt = b + static_cast<size_t>(t) * n;
    if (vec) {
      constexpr int E = 16 / sizeof(T);
      const int cpr = n / E;  // chunks per row
      for (int q = lane; q < n * cpr; q += 32) {
        const int i = q / cpr;
        const int c = q - i * cpr;
        if (c * E <= i) cp_async_16(Ds + i * ldd + c * E, Dt + i * n + c * E);
        if (t > 0) cp_async_16(Os + i * NP + c * E, Ot + i * n + c * E);
      }
      if (lane < cpr) cp_async_16(bs + lane * E, bt + lane * E);
    } else {
      for (int i = i0, k = k0; i < n;) {
        cp_async_elem(Ds + i * ldd + k, Dt + i * n + k);
        k += 32;
        while (k > i) {
          k -= i + 1;
          ++i;
        }
      }
      if (t > 0) {
        for (int i = 0, k = lane, e = lane; e < n * n; e += 32) {
          while (k >= n) {
            k -= n;
            ++i;
          }
          cp_async_elem(Os + i * NP + k, Ot + e);
          k += 32;
        }
      }
      if (lane < n) cp_async_elem(bs + lane, bt + lane);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// x_t = Ld_t^{-T} (y_t - M_{t+1}' x_{t+1}) from the kept blocks at P
// (shared memory or device scratch: inlined once for each).
template <typename T, int NP>
__device__ __forceinline__ void backward_sweep(const T* P, T* x, int Tn, int n, int lane) {
  const int ld = warp_ld(n);
  const size_t kept = kept_elems(n);
  const size_t mt = kept_mt_offset(n), yo = kept_y_offset(n);
  const bool row = lane < n;
  const int lr = row ? lane : n - 1;  // a row to read that exists; lanes past n discard it
  const int lm = lane < NP ? lane : NP - 1;
  T xr = T(0);  // lane l holds x_{t+1}[l]; padded rows hold 0
  for (int t = Tn - 1; t >= 0; --t) {
    const T* Pt = P + static_cast<size_t>(t) * kept;
    T r = Pt[yo + lr];
    r = row ? r : T(0);
    T rdi = Pt[yo + n + lr];
    rdi = row ? rdi : T(1);
    T lc[NP];  // column `lane` of Ld_t below the diagonal, 0 elsewhere
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const T v = Pt[(j < n ? j : n - 1) * ld + lr];
      lc[j] = (lane < j && j < n) ? v : T(0);
    }
    if (t < Tn - 1) {
      const T* Mn = P + static_cast<size_t>(t + 1) * kept + mt;  // M_{t+1}', NP x NP
#pragma unroll
      for (int l = 0; l < NP; ++l) {
        const T ml = Mn[lm * NP + l];
        r -= (row ? ml : T(0)) * __shfl_sync(kFull, xr, l);
      }
    }
#pragma unroll
    for (int j = NP - 1; j >= 0; --j) {
      // lc[j] is exactly 0 on lanes >= j, so they keep their r
      r -= lc[j] * __shfl_sync(kFull, r * rdi, j);
    }
    xr = r * rdi;
    if (row) x[static_cast<size_t>(t) * n + lane] = xr;
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bt_warp_kernel(const T* __restrict__ D, const T* __restrict__ O, const T* __restrict__ b,
                   T* __restrict__ x, T* __restrict__ scratch, int bsz, int Tn, int n,
                   int all_in_smem, int warps) {
  using V = typename Vec16<T>::type;
  constexpr int W = Vec16<T>::width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long s = static_cast<long long>(blockIdx.x) * warps + w;
  // A warp without a sample leaves; nothing below waits for another warp.
  if (s >= bsz) return;

  const int ld = warp_ld(n);
  const size_t stage = stage_elems(n);
  const size_t o_off = stage_o_offset(n);
  const size_t b_off = stage_b_offset(n);
  // 16-byte copies when every row starts 16-byte aligned
  const bool vec = (n * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<unsigned long long>(D) |
                     reinterpret_cast<unsigned long long>(O) |
                     reinterpret_cast<unsigned long long>(b)) & 15) == 0;
  const int ldd = vec ? NP + static_cast<int>(16 / sizeof(T)) : NP + 1;  // D's row stride in a stage
  const size_t kept = kept_elems(n);
  const size_t mt = kept_mt_offset(n), yo = kept_y_offset(n);
  const bool row = lane < n;
  const int lrow = lane < NP ? lane : NP - 1;  // lanes past NP work on a copy of row NP-1
  T* wsm = reinterpret_cast<T*>(smem_raw) + w * warp_smem_elems(Tn, n, all_in_smem);
  T* Psm = wsm + 2 * stage;  // the kept blocks, or the working M_t'
  T* Pg = all_in_smem ? nullptr : scratch + s * Tn * kept;

  D += s * Tn * n * n;
  O += s * (Tn > 1 ? Tn - 1 : 0) * n * n;
  b += s * Tn * n;
  x += s * Tn * n;

  // this lane's first element of D's packed lower triangle
  int i0 = 0, k0 = lane;
  while (k0 > i0) {
    k0 -= i0 + 1;
    ++i0;
  }
  // the padding of both stages: identity rows in D, zeros in O and b (and
  // O of stage 0 stays zero, so M_0 = 0 and S_0 = D_0 with no branch)
  {
    uint4* z = reinterpret_cast<uint4*>(wsm);
    const int chunks = static_cast<int>(2 * stage * sizeof(T) / 16);
    for (int e = lane; e < chunks; e += 32) z[e] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    if (lane >= n && lane < NP) {
      wsm[lane * ldd + lane] = T(1);
      wsm[stage + lane * ldd + lane] = T(1);
    }
    __syncwarp();
  }
  prefetch_stage<T, NP>(wsm, D, O, b, 0, Tn, n, ldd, vec, lane, i0, k0);
  prefetch_stage<T, NP>(wsm + stage, D, O, b, 1, Tn, n, ldd, vec, lane, i0, k0);

  T srow[NP];  // row `lane` of S_t, factored in place into row `lane` of Ld_t
  T lp[NP];    // row `lane` of Ld_{t-1}
  T m[NP];     // row `lane` of M_t
  T rdi = T(1), rdp = T(1);  // 1/Ld_t[lane][lane], 1/Ld_{t-1}[lane][lane]
  T yp = T(0);  // y_{t-1}[lane]
  T rp = T(0);  // [lane] of b_{t-1} - M_{t-1} y_{t-2}, the forward sweep's rhs
#pragma unroll
  for (int k = 0; k < NP; ++k) lp[k] = T(0);

  for (int t = 0; t < Tn; ++t) {
    // ---- stage t has arrived: take this lane's row of D_t, b_t and
    // column of O_{t-1} (zero at t = 0, so M_0 = 0 and S_0 = D_0 with no
    // branch), then refill the buffer with stage t+2 ----
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    T* st = wsm + (t & 1) * stage;
#pragma unroll
    for (int k = 0; k < NP; ++k) srow[k] = st[lrow * ldd + k];
    T r = st[b_off + lrow];
#pragma unroll
    for (int i = 0; i < NP; ++i) m[i] = st[o_off + i * NP + lrow];
    __syncwarp();
    prefetch_stage<T, NP>(st, D, O, b, t + 2, Tn, n, ldd, vec, lane, i0, k0);

    T* Pt = all_in_smem ? Psm + t * kept : Pg + t * kept;
    T* Mw = all_in_smem ? Psm + t * kept + mt : Psm;  // M_t', in shared memory either way

    // ---- column `lane` of X = Ld_{t-1}^{-1} O_{t-1}, which is row `lane`
    // of M_t; published as column `lane` of M_t' ----
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const T xi = m[i] * __shfl_sync(kFull, rdp, i);
      m[i] = xi;
#pragma unroll
      for (int k = i + 1; k < NP; ++k) m[k] -= __shfl_sync(kFull, lp[i], k) * xi;
    }
#pragma unroll
    for (int l = 0; l < NP; ++l) {
      if (lane < NP) Mw[l * NP + lane] = m[l];
      if (!all_in_smem && lane < NP) Pt[mt + l * NP + lane] = m[l];
    }
    __syncwarp();

    // ---- S = D_t - M_t M_t' (row `lane`; entries above the diagonal
    // unused), M_t's rows read W at a time as broadcasts from M_t'. Column
    // groups are finished in order, so the Cholesky can start early ----
#pragma unroll
    for (int k = 0; k < NP; k += W) {
#pragma unroll
      for (int l = 0; l < NP; ++l) {
        const V v = *reinterpret_cast<const V*>(Mw + l * NP + k);
#pragma unroll
        for (int c = 0; c < W; ++c) srow[k + c] -= m[l] * Vec16<T>::get(v, c);
      }
    }

    // ---- right-looking Cholesky: lane i keeps row i. One reciprocal
    // square root per pivot; the next pivot is lane j+1's own diagonal
    // after column j, shuffled before the rest of column j's update ----
    T piv = __shfl_sync(kFull, srow[0], 0);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const T rd = pivot_rsqrt(piv);
      srow[j] = lane == j ? piv * rd : srow[j] * rd;
      rdi = lane == j ? rd : rdi;
      if (j + 1 < NP) piv = __shfl_sync(kFull, srow[j + 1] - srow[j] * srow[j], j + 1);
#pragma unroll
      for (int k = j + 1; k < NP; ++k) srow[k] -= srow[j] * __shfl_sync(kFull, srow[j], k);
    }

    // ---- forward sweep of block t-1, y_{t-1} = Ld_{t-1}^{-1} rp: it is
    // independent of block t's Cholesky, so the two chains interleave ----
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const T yj = __shfl_sync(kFull, rp * rdp, j);
      rp = lane > j ? rp - lp[j] * yj : rp;
    }
    yp = rp * rdp;
    // rhs of block t: b_t - M_t y_{t-1}
#pragma unroll
    for (int l = 0; l < NP; ++l) r -= m[l] * __shfl_sync(kFull, yp, l);

    // keep Ld_t (strictly lower), 1/diag and y_{t-1} for the backward sweep
    if (row) {
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        if (k < lane) Pt[lane * ld + k] = srow[k];
      }
      Pt[yo + n + lane] = rdi;
      if (t > 0) (Pt - kept)[yo + lane] = yp;
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) lp[k] = srow[k];
    rdp = rdi;
    rp = r;
  }

  // ---- forward sweep of the last block ----
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const T yj = __shfl_sync(kFull, rp * rdp, j);
    rp = lane > j ? rp - lp[j] * yj : rp;
  }
  if (row) {
    T* Pt = (all_in_smem ? Psm : Pg) + static_cast<size_t>(Tn - 1) * kept;
    Pt[yo + lane] = rp * rdp;
  }

  __syncwarp();  // the kept blocks written by every lane are visible
  if (all_in_smem) {
    backward_sweep<T, NP>(Psm, x, Tn, n, lane);
  } else {
    backward_sweep<T, NP>(Pg, x, Tn, n, lane);
  }
}

template <typename T, int NP>
int launch_warp_np(const T* D, const T* O, const T* b, T* x, T* scratch, int bsz, int Tn, int n,
                   int all_in_smem, int warps, cudaStream_t stream) {
  const size_t smem = warps * warp_smem_elems(Tn, n, all_in_smem) * sizeof(T);
  if (smem > 48 * 1024) {
    // the opt-in is a property of the function on the current device: set
    // it once per device for the largest size asked so far
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    static size_t opted[64] = {};
    if (dev >= 64 || opted[dev] < smem) {
      e = cudaFuncSetAttribute(bt_warp_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < 64) opted[dev] = smem;
    }
  }
  const int grid = (bsz + warps - 1) / warps;
  bt_warp_kernel<T, NP><<<grid, warps * 32, smem, stream>>>(D, O, b, x, scratch, bsz, Tn, n,
                                                            all_in_smem, warps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_warp(const T* D, const T* O, const T* b, T* x, T* scratch, int bsz, int Tn, int n,
                int all_in_smem, int warps, void* stream) {
  if (bsz <= 0 || Tn <= 0 || n <= 0 || n > 32 || warps <= 0 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!all_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_n(n)) {
    case 4:
      return launch_warp_np<T, 4>(D, O, b, x, scratch, bsz, Tn, n, all_in_smem, warps, st);
    case 8:
      return launch_warp_np<T, 8>(D, O, b, x, scratch, bsz, Tn, n, all_in_smem, warps, st);
    case 16:
      return launch_warp_np<T, 16>(D, O, b, x, scratch, bsz, Tn, n, all_in_smem, warps, st);
    case 24:
      return launch_warp_np<T, 24>(D, O, b, x, scratch, bsz, Tn, n, all_in_smem, warps, st);
    default:
      return launch_warp_np<T, 32>(D, O, b, x, scratch, bsz, Tn, n, all_in_smem, warps, st);
  }
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may opt in to on `device`, in
// bytes; a negative value is a CUDA error code.
int bt_smem_optin(int device) {
  int v = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

// ---- the warp kernel: n <= 32, `warps` samples per CTA (1 to 4) ----

// Dynamic shared memory of one CTA, in bytes.
size_t bt_warp_smem_bytes(int T, int n, int elem_size, int all_in_smem, int warps) {
  return warps * warp_smem_elems(T, n, all_in_smem) * static_cast<size_t>(elem_size);
}

// Device scratch per sample when not all_in_smem, in elements.
size_t bt_warp_scratch_elems(int T, int n) { return static_cast<size_t>(T) * kept_elems(n); }

int bt_warp_solve_f32(const float* D, const float* O, const float* b, float* x, float* scratch,
                      int bsz, int T, int n, int all_in_smem, int warps, void* stream) {
  return launch_warp<float>(D, O, b, x, scratch, bsz, T, n, all_in_smem, warps, stream);
}

int bt_warp_solve_f64(const double* D, const double* O, const double* b, double* x,
                      double* scratch, int bsz, int T, int n, int all_in_smem, int warps,
                      void* stream) {
  return launch_warp<double>(D, O, b, x, scratch, bsz, T, n, all_in_smem, warps, stream);
}

// ---- the block kernel: any n, one sample per CTA ----

// Dynamic shared memory a launch needs, in bytes.
size_t bt_block_smem_bytes(int T, int n, int elem_size, int all_in_smem) {
  return smem_elems(T, n, all_in_smem) * static_cast<size_t>(elem_size);
}

int bt_block_solve_f32(const float* D, const float* O, const float* b, float* x, float* scratch,
                       int bsz, int T, int n, int all_in_smem, void* stream) {
  return launch_block<float>(D, O, b, x, scratch, bsz, T, n, all_in_smem, stream);
}

int bt_block_solve_f64(const double* D, const double* O, const double* b, double* x,
                       double* scratch, int bsz, int T, int n, int all_in_smem, void* stream) {
  return launch_block<double>(D, O, b, x, scratch, bsz, T, n, all_in_smem, stream);
}

}  // extern "C"
