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
//   * gather_rows and gather_window are one row-gather template whose
//     source row comes from a small index functor: idx[e]*q + j for
//     gather_rows, wins[t / bucket]*span + offs[t] for gather_window. The
//     kernel moves whole rows with vector loads and stores as wide as
//     the row allows: 16 B where the row's bytes and both arrays' addresses
//     are multiples of 16, else 8 B, else 4 B (r = 10 float32 rows of 40 B
//     move as 8 B vectors, r = 20 rows of 80 B as 16 B vectors). A row
//     takes a sub-warp of vpr = row bytes / vector bytes lanes (five at
//     r = 10 and 20), a warp 32 / vpr rows side by side, so a warp's store
//     is one contiguous run of whole rows; each lane reads its row's id
//     once (the lanes of one row share the load) and keeps four rows in
//     flight (four ids, then four vector loads, then four stores) before
//     its first store. The output, read once by the caller, is written
//     with streaming stores (__stcs). The one division (lane by vpr) is
//     done once per thread. Rows wider than 32 vectors take a warp each,
//     its lanes stepping along the row. On the solver's path the SpMM
//     gathers tier 1 and tier 2 in one launch (ops/spmm.py). A window
//     gather takes the same scheme: 4 lanes per row at r = 16 float32,
//     8 at r = 32, the window base read once per row (the lanes of one
//     row, and the rows of one tile, share the load), 32-bit offsets
//     where they fit;
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

constexpr int ROWS_UNROLL = 4;   // rows in flight per lane

// a vector V of NaNs of type T (V: int, int2 or int4, as raw bits)
template <typename T, typename V>
__device__ __forceinline__ V nan_vec() {
  const int hi = sizeof(T) == 8 ? 0x7ff80000 : 0x7fc00000;
  const int lo = sizeof(T) == 8 ? 0 : hi;
  V v;
  int* w = reinterpret_cast<int*>(&v);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(V) / 4); ++i) w[i] = (i & 1) ? hi : lo;
  return v;
}

// The source rows, as 64-bit row numbers (the range test is made in 64
// bits, so no index wraps into range): out row t of a row gather is X row
// idx[t / q]*q + t % q ...
template <typename I, typename Off>
struct RowIndex {
  const I* idx;
  Off q;
  __device__ __forceinline__ unsigned long long operator()(Off row) const {
    const Off e = q == 1 ? row : row / q;
    return (unsigned long long)(long long)__ldg(idx + e) * q + (row - e * q);
  }
};

// ... and of a window gather X row wins[t / bucket]*span + offs[t].
template <typename I, typename Off>
struct WindowIndex {
  const I* wins;
  const I* offs;
  Off span, bucket;
  __device__ __forceinline__ unsigned long long operator()(Off row) const {
    return (unsigned long long)(long long)__ldg(wins + row / bucket) * span +
           (unsigned long long)(long long)__ldg(offs + row);
  }
};

// out row t (of rows) = X row src(t), moved as vpr vectors V per row.
// Sub-warps of vpr lanes per row, rpw = 32 / vpr rows per warp,
// ROWS_UNROLL row groups per warp in flight; vpr > 32: one row per warp,
// lanes stepping along it.
template <typename T, typename V, typename Src, typename Off>
__global__ void __launch_bounds__(NT)
gather_rows_kernel(const V* __restrict__ X, Src src_of, V* __restrict__ out,
                   Off rows, int vpr, Off n_rows) {
  const int lane = threadIdx.x & 31;
  const int rpw = vpr <= 32 ? 32 / vpr : 1;
  const int rw = vpr <= 32 ? lane / vpr : 0;
  const int c = vpr <= 32 ? lane - rw * vpr : lane;
  const bool active = rw < rpw;
  const Off gw = ((Off)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const Off tw = ((Off)gridDim.x * blockDim.x) >> 5;
  const Off ngroups = (rows + rpw - 1) / rpw;
  const V nanv = nan_vec<T, V>();
  for (Off g0 = gw; g0 < ngroups; g0 += tw * ROWS_UNROLL) {
    Off row[ROWS_UNROLL];
    unsigned long long src[ROWS_UNROLL];
#pragma unroll
    for (int u = 0; u < ROWS_UNROLL; ++u) {
      const Off g = g0 + u * tw;
      row[u] = g * rpw + rw;
      src[u] = ~0ULL;
      if (active && g < ngroups && row[u] < rows) src[u] = src_of(row[u]);
    }
    if (vpr <= 32) {
      V val[ROWS_UNROLL];
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u)
        val[u] = src[u] < (unsigned long long)n_rows
                     ? __ldg(X + (Off)src[u] * vpr + c) : nanv;
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u) {
        const Off g = g0 + u * tw;
        if (active && g < ngroups && row[u] < rows)
          __stcs(out + row[u] * vpr + c, val[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u) {
        const Off g = g0 + u * tw;
        if (g >= ngroups || row[u] >= rows) continue;
        const bool ok = src[u] < (unsigned long long)n_rows;
        for (int cc = c; cc < vpr; cc += 32)
          __stcs(out + row[u] * vpr + cc,
                 ok ? __ldg(X + (Off)src[u] * vpr + cc) : nanv);
      }
    }
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

// The source-row functor of a launch at offset type Off: a row gather's
// (idx, q) or a window gather's (wins, offs, span, bucket).
template <typename I>
struct RowArgs {
  const void* idx;
  long long q;
  template <typename Off>
  RowIndex<I, Off> at() const { return {(const I*)idx, (Off)q}; }
};

template <typename I>
struct WindowArgs {
  const void *wins, *offs;
  long long span, bucket;
  template <typename Off>
  WindowIndex<I, Off> at() const {
    return {(const I*)wins, (const I*)offs, (Off)span, (Off)bucket};
  }
};

template <typename T, typename V, typename A>
int rows_launch_v(const void* X, long long n_rows, const A& src, void* out,
                  long long rows, int vpr, cudaStream_t st) {
  const int rpw = vpr <= 32 ? 32 / vpr : 1;
  const long long groups = (rows + rpw - 1) / rpw;
  const int grid = grid_for((groups + ROWS_UNROLL - 1) / ROWS_UNROLL * 32);
  if (rows * vpr < (1LL << 31) && n_rows * vpr < (1LL << 31))
    gather_rows_kernel<T, V><<<grid, NT, 0, st>>>(
        (const V*)X, src.template at<uint32_t>(), (V*)out, (uint32_t)rows,
        vpr, (uint32_t)n_rows);
  else
    gather_rows_kernel<T, V><<<grid, NT, 0, st>>>(
        (const V*)X, src.template at<uint64_t>(), (V*)out, (uint64_t)rows,
        vpr, (uint64_t)n_rows);
  return (int)cudaGetLastError();
}

// out (rows, r): the widest vector (16, 8 or 4 bytes) that divides the
// row and both arrays' addresses
template <typename T, typename A>
int rows_launch(const void* X, long long n_rows, const A& src, void* out,
                long long rows, int r, cudaStream_t st) {
  const long long row_bytes = (long long)r * sizeof(T);
  const unsigned long long al = (unsigned long long)X | (unsigned long long)out;
  if (row_bytes % 16 == 0 && al % 16 == 0)
    return rows_launch_v<T, int4>(X, n_rows, src, out, rows,
                                  (int)(row_bytes / 16), st);
  if (row_bytes % 8 == 0 && al % 8 == 0)
    return rows_launch_v<T, int2>(X, n_rows, src, out, rows,
                                  (int)(row_bytes / 8), st);
  return rows_launch_v<T, int>(X, n_rows, src, out, rows,
                               (int)(row_bytes / 4), st);
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
  const long long rows = E * q;
  if (is_double)
    return idx64 ? rows_launch<double>(X, n_rows, RowArgs<long long>{idx, q},
                                       out, rows, r, st)
                 : rows_launch<double>(X, n_rows, RowArgs<int>{idx, q}, out,
                                       rows, r, st);
  return idx64 ? rows_launch<float>(X, n_rows, RowArgs<long long>{idx, q}, out,
                                    rows, r, st)
               : rows_launch<float>(X, n_rows, RowArgs<int>{idx, q}, out, rows,
                                    r, st);
}

// out (rows, r) with rows = len(wins)*bucket; wins and offs share one
// index type.
int gather_window(const void* X, long long n_rows, const void* wins,
                  const void* offs, void* out, long long rows, int r,
                  int span, int bucket, int is_double, int idx64,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const WindowArgs<long long> w64{wins, offs, span, bucket};
  const WindowArgs<int> w32{wins, offs, span, bucket};
  if (is_double)
    return idx64 ? rows_launch<double>(X, n_rows, w64, out, rows, r, st)
                 : rows_launch<double>(X, n_rows, w32, out, rows, r, st);
  return idx64 ? rows_launch<float>(X, n_rows, w64, out, rows, r, st)
               : rows_launch<float>(X, n_rows, w32, out, rows, r, st);
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
