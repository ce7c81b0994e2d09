// Row, window and lane gathers for NVIDIA Hopper (sm_90a): the gather of
// the ELL SpMM (C@X, the S-matvec of every Lanczos pass) and the
// counterparts of the gather probes the JAX package wrote in Pallas.
//
// Replaces these Pallas TPU kernels (each computes what they compute; none
// of the TPU mechanics carries over: no one-hot MXU matmul, no (8, 128)
// tiles, no DMA-semaphore ring):
//   gather_rows    out[e*q + j, :] = X[idx[e]*q + j, :], j < q
//                  exps/probe3.py::_full_take_call (P1),
//                  exps/probe3.py::_sublane_take_call (P2),
//                  exps/probe_gather.py::_pallas_take_call (P3)   (q = 1),
//                  exps/probe5.py::_dma_gather (P4)     (q = rows_per_dma);
//                  on the solver's path it is the row take of
//                  sdplrplus_tpu/ops/spmm.py::spmm_gather;
//   gather_window  out[t*bucket + j, :] = X[wins[t]*span + offs[t*bucket + j], :]
//                  exps/probe2.py::_onehot_call (P5),
//                  exps/probe_gather.py::_pallas_onehot_call (P6);
//   gather_lanes   out[s, l] = X[s, idx[s, l]]
//                  exps/probe3.py::_lane_gather_call (P7),
//                  exps/probe3.py::_lane_gather_grid (P8).
// The Python wrappers and the plain PyTorch versions are in
// sdplrplus_tpu_torch/ops/gather.py.
//
// What bounds them: bytes. Each index is read once and each output value
// written once; X itself (0.8 MB at n = 20,096, r = 10; 6.4 MB at the
// probes' N = 100,000, r = 16) sits in the 50 MB L2, so the rows gathered
// from it are L2 hits and X costs HBM one read. At the solver's shapes
// (SYN20K, one SpMM: 733,568 int64 indices over tiers 1 and 2, r = 10,
// float32) that is 5.9 MB of indices, 0.8 MB of X and 29.3 MB written,
// about 10.7 us at the card's 3.35 TB/s.
//
// What the design does about it:
//   * one thread per output element over a flat grid-stride loop, so
//     neighbouring threads write neighbouring addresses (the output
//     stream is fully coalesced) and each warp loads one short row, or a
//     few (r = 10: three rows per warp), as one contiguous segment. Rows
//     of any width are taken, including widths that are not a multiple of
//     4 (r = 10 and 20 on the solver's path, rows not 16-byte aligned), so
//     loads are scalar; the index is a broadcast load within a row;
//   * indices are read through the read-only path (__ldg) once per
//     element of their row: repeated loads of one index hit L1;
//   * flat offsets are 32-bit when the output fits, so the division that
//     maps an element to its row is the cheap 32-bit one;
//   * gather_lanes stages one row of X in shared memory when it fits in
//     48 KB and every lookup of that row reads shared memory; a longer
//     row is read straight from global memory (L2).
// Padding slots of the ELL layout point at a row that is guaranteed to be
// zero (compile.py), so no kernel masks. An index outside X (negative ones
// included) reads nothing and gives NaN in its output row or entry, one
// compare per element; the plain versions raise on it (or count a negative
// one from the end).
//
// Every entry point launches on the caller's stream, does not synchronise
// and returns a cudaError_t (the launch's, via cudaGetLastError).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;                    // threads per block
constexpr int MAX_BLOCKS = 132 * 16;       // grid-stride cap: 16 per SM
constexpr int LANE_SMEM_BYTES = 48 * 1024;  // gather_lanes' staged row

template <typename Off>
__device__ __forceinline__ Off flat_start() {
  return (Off)blockIdx.x * (Off)blockDim.x + (Off)threadIdx.x;
}

template <typename Off>
__device__ __forceinline__ Off flat_stride() {
  return (Off)gridDim.x * (Off)blockDim.x;
}

template <typename T, typename I, typename Off>
__global__ void __launch_bounds__(NT)
gather_rows_kernel(const T* __restrict__ X, const I* __restrict__ idx,
                   T* __restrict__ out, Off total, Off r, Off q,
                   Off n_rows) {
  for (Off t = flat_start<Off>(); t < total; t += flat_stride<Off>()) {
    const Off row = t / r;
    const Off col = t - row * r;
    const Off e = row / q;
    const Off j = row - e * q;
    // the range test in 64 bits, so no index wraps into range
    const unsigned long long src =
        (unsigned long long)(long long)__ldg(idx + e) * q + j;
    out[t] = src < n_rows ? __ldg(X + (Off)src * r + col) : (T)NAN;
  }
}

template <typename T, typename I, typename Off>
__global__ void __launch_bounds__(NT)
gather_window_kernel(const T* __restrict__ X, const I* __restrict__ wins,
                     const I* __restrict__ offs, T* __restrict__ out,
                     Off total, Off r, Off span, Off bucket, Off n_rows) {
  for (Off t = flat_start<Off>(); t < total; t += flat_stride<Off>()) {
    const Off row = t / r;
    const Off col = t - row * r;
    const Off tile = row / bucket;
    // the tile's window base plus the offset, range-tested in 64 bits
    const unsigned long long src =
        (unsigned long long)(long long)__ldg(wins + tile) * span
        + (unsigned long long)(long long)__ldg(offs + row);
    out[t] = src < n_rows ? __ldg(X + (Off)src * r + col) : (T)NAN;
  }
}

// One block per row (grid-stride over rows); the row goes through shared
// memory when ``staged``.
template <typename T, typename I>
__global__ void __launch_bounds__(NT)
gather_lanes_kernel(const T* __restrict__ X, const I* __restrict__ idx,
                    T* __restrict__ out, long long S, long long L,
                    int staged) {
  extern __shared__ unsigned char smem_raw[];
  T* row_s = reinterpret_cast<T*>(smem_raw);
  for (long long s = blockIdx.x; s < S; s += gridDim.x) {
    const T* xrow = X + s * L;
    const I* irow = idx + s * L;
    T* orow = out + s * L;
    if (staged) {
      __syncthreads();  // the previous row's lookups are done
      for (long long l = threadIdx.x; l < L; l += blockDim.x)
        row_s[l] = __ldg(xrow + l);
      __syncthreads();
      for (long long l = threadIdx.x; l < L; l += blockDim.x) {
        const unsigned long long k = (unsigned long long)__ldg(irow + l);
        orow[l] = k < (unsigned long long)L ? row_s[k] : (T)NAN;
      }
    } else {
      for (long long l = threadIdx.x; l < L; l += blockDim.x) {
        const unsigned long long k = (unsigned long long)__ldg(irow + l);
        orow[l] = k < (unsigned long long)L ? __ldg(xrow + k) : (T)NAN;
      }
    }
  }
}

int grid_for(long long total) {
  long long blocks = (total + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T, typename I>
int rows_launch(const void* X, long long n_rows, const void* idx, void* out,
                long long E, int r, int q, cudaStream_t st) {
  const long long total = E * q * r;
  const int grid = grid_for(total);
  if (total < (1LL << 31) && n_rows * r < (1LL << 31))
    gather_rows_kernel<T, I, uint32_t><<<grid, NT, 0, st>>>(
        (const T*)X, (const I*)idx, (T*)out, (uint32_t)total, (uint32_t)r,
        (uint32_t)q, (uint32_t)n_rows);
  else
    gather_rows_kernel<T, I, uint64_t><<<grid, NT, 0, st>>>(
        (const T*)X, (const I*)idx, (T*)out, (uint64_t)total, (uint64_t)r,
        (uint64_t)q, (uint64_t)n_rows);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int window_launch(const void* X, long long n_rows, const void* wins,
                  const void* offs, void* out, long long rows, int r,
                  int span, int bucket, cudaStream_t st) {
  const long long total = rows * r;
  const int grid = grid_for(total);
  if (total < (1LL << 31) && n_rows * r < (1LL << 31))
    gather_window_kernel<T, I, uint32_t><<<grid, NT, 0, st>>>(
        (const T*)X, (const I*)wins, (const I*)offs, (T*)out,
        (uint32_t)total, (uint32_t)r, (uint32_t)span, (uint32_t)bucket,
        (uint32_t)n_rows);
  else
    gather_window_kernel<T, I, uint64_t><<<grid, NT, 0, st>>>(
        (const T*)X, (const I*)wins, (const I*)offs, (T*)out,
        (uint64_t)total, (uint64_t)r, (uint64_t)span, (uint64_t)bucket,
        (uint64_t)n_rows);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int lanes_launch(const void* X, const void* idx, void* out, long long S,
                 long long L, cudaStream_t st) {
  const int staged = L * (long long)sizeof(T) <= LANE_SMEM_BYTES;
  const size_t smem = staged ? (size_t)L * sizeof(T) : 0;
  long long grid = S < MAX_BLOCKS ? S : MAX_BLOCKS;
  if (grid < 1) grid = 1;
  gather_lanes_kernel<T, I><<<(int)grid, NT, smem, st>>>(
      (const T*)X, (const I*)idx, (T*)out, S, L, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (E*q, r) = rows idx[e]*q + j of X (n_rows, r), row-major,
// contiguous. is_double: X and out are double; idx64: idx is int64.
int gather_rows(const void* X, long long n_rows, const void* idx, void* out,
                long long E, int r, int q, int is_double, int idx64,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return idx64 ? rows_launch<double, long long>(X, n_rows, idx, out, E, r,
                                                  q, st)
                 : rows_launch<double, int>(X, n_rows, idx, out, E, r, q, st);
  return idx64 ? rows_launch<float, long long>(X, n_rows, idx, out, E, r, q,
                                               st)
               : rows_launch<float, int>(X, n_rows, idx, out, E, r, q, st);
}

// out (rows, r) with rows = len(wins)*bucket; wins and offs share one
// index type.
int gather_window(const void* X, long long n_rows, const void* wins,
                  const void* offs, void* out, long long rows, int r,
                  int span, int bucket, int is_double, int idx64,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return idx64 ? window_launch<double, long long>(X, n_rows, wins, offs,
                                                    out, rows, r, span,
                                                    bucket, st)
                 : window_launch<double, int>(X, n_rows, wins, offs, out,
                                              rows, r, span, bucket, st);
  return idx64 ? window_launch<float, long long>(X, n_rows, wins, offs, out,
                                                 rows, r, span, bucket, st)
               : window_launch<float, int>(X, n_rows, wins, offs, out, rows,
                                           r, span, bucket, st);
}

// out (S, L) = X (S, L) taken along each row at idx (S, L).
int gather_lanes(const void* X, const void* idx, void* out, long long S,
                 long long L, int is_double, int idx64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return idx64 ? lanes_launch<double, long long>(X, idx, out, S, L, st)
                 : lanes_launch<double, int>(X, idx, out, S, L, st);
  return idx64 ? lanes_launch<float, long long>(X, idx, out, S, L, st)
               : lanes_launch<float, int>(X, idx, out, S, L, st);
}

const char* gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
