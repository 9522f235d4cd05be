// Batched block-tridiagonal SPD solve H x = b for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_solve_kernel`
// (deqmpc_tpu/ops/pallas_tridiag.py:100-129), launched there by
// `_pallas_solve_lanes` behind `pallas_block_tridiag_solve`. It computes
// the same function, not a block-by-block copy: the TPU kernel put the
// batch in 128-wide vector lanes and padded it with identity blocks; here
// one thread block owns one sample and nothing is padded.
//
//   D (bsz, T, n, n) diagonal blocks, O (bsz, T-1, n, n) with
//   H[t, t+1] = O[t], b (bsz, T, n)  ->  x (bsz, T, n), all row-major.
//   Ld_t Ld_t' = D_t - M_t M_t',   M_t = O_{t-1}' Ld_{t-1}^{-T}
//   y_t = Ld_t^{-1} (b_t - M_t y_{t-1}),  x_t = Ld_t^{-T} (y_t - M_{t+1}' x_{t+1})
//
// What bounds it on this card: the bytes of D, O and b are read once
// (about 9.5 MB at bsz 1024, T 5, n 16 in f32: under 3 us at 3.35 TB/s),
// but each sample is a sequential chain of T small Cholesky steps, each
// with O(n) dependent column steps. So it is bound by latency, not by
// bytes or operations.
// What the simple design does about it: one block per sample, so the
// batch fills the 132 SMs; the recursion over T is a loop inside the
// block; each Ld_t and M_t stays in shared memory when all T of them fit
// (dynamic shared memory, opted in above 48 KB), else they go to scratch
// in device memory that the wrapper allocates, and only the block being
// worked on lives in shared memory. Any T works. The forward sweep runs
// inside the factorization loop and keeps y in x, which the backward
// sweep then overwrites in place.
// A pivot that is not positive (or NaN) gives NaN, never a clamped value,
// so a block that is not SPD turns its whole sample into NaN, as
// `lax.linalg.cholesky` does, and leaves the other samples alone.
//
// Binding: a plain C interface loaded with ctypes; no PyTorch headers.
// The launcher runs on the caller's stream, allocates nothing and returns
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
int launch(const T* D, const T* O, const T* b, T* x, T* scratch, int bsz, int Tn, int n,
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

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes.
size_t bt_smem_bytes(int T, int n, int elem_size, int all_in_smem) {
  return smem_elems(T, n, all_in_smem) * static_cast<size_t>(elem_size);
}

// The most dynamic shared memory a block may opt in to on `device`, in
// bytes; a negative value is a CUDA error code.
int bt_smem_optin(int device) {
  int v = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

int bt_solve_f32(const float* D, const float* O, const float* b, float* x, float* scratch,
                 int bsz, int T, int n, int all_in_smem, void* stream) {
  return launch<float>(D, O, b, x, scratch, bsz, T, n, all_in_smem, stream);
}

int bt_solve_f64(const double* D, const double* O, const double* b, double* x,
                 double* scratch, int bsz, int T, int n, int all_in_smem, void* stream) {
  return launch<double>(D, O, b, x, scratch, bsz, T, n, all_in_smem, stream);
}

}  // extern "C"
