// Device code shared by the two inner-loop megakernels, K1
// (csrc/megakernel.cu) and K2 (csrc/megakernel_armijo.cu): the layout
// limits, the fixed-order reductions, the D.C register-tile product, the
// compact L-BFGS direction's k x k solves, the grid plan and the timing
// builds' stamps. Both kernels are one cooperative persistent grid (one
// block per SM), each block owning a slab of S = ceil(n_pad / #SMs) <= 16
// columns; their heads have the design notes.
//
// Every reduction here sums in one fixed order, so a total is bitwise the
// same in every block: the kernels take every decision (alpha, the
// stagnation flag, the loop exit) in every block alike, with no atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int IC = 64;           // n-axis granule: the product's i-lanes
constexpr int MAX_RP = 64;
constexpr int MAX_S = 16;        // columns per block (the slab stride)
constexpr int MAX_K = 16;
constexpr int MAX_LR = 4;        // low-rank terms (MAX_LR_TERMS)
constexpr int MAX_LRC = 8;       // low-rank columns over all terms
constexpr int MAX_NBLK = 160;    // grid_totals reads 5 partials per lane
constexpr int DB = 8;            // the product's 64-column steps per load batch
constexpr int SMEM_MAX = 232448; // a block's shared memory on sm_90

// ---- timing builds ----------------------------------------------------------
// With K1_TIMING or K2_TIMING, thread 0 of block 0 adds the %globaltimer
// time between consecutive STAMPs to its phase's sum and GRID_SYNC counts
// the grid barriers; TIMER_WRITE stores the sums (ns), the barrier count
// and the entry barriers to tbuf (int64). Without either macro the stamps
// compile to nothing.
#if defined(K1_TIMING) || defined(K2_TIMING)
__device__ __forceinline__ unsigned long long mk_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TIMER_DECL(nph)                                \
  const bool tmr = blockIdx.x == 0 && threadIdx.x == 0; \
  unsigned long long tacc[nph] = {}, tprev = 0;         \
  long long nbar = 0, nbar_entry = 0
#define TIMER_ENTRY()             \
  do {                            \
    nbar_entry = nbar;            \
    if (tmr) tprev = mk_now();    \
  } while (0)
#define STAMP(ph)                       \
  do {                                  \
    if (tmr) {                          \
      unsigned long long t_ = mk_now(); \
      tacc[ph] += t_ - tprev;           \
      tprev = t_;                       \
    }                                   \
  } while (0)
#define GRID_SYNC() \
  do {              \
    grid.sync();    \
    ++nbar;         \
  } while (0)
#define TIMER_WRITE(tbuf, nph)                                    \
  do {                                                            \
    if (tmr && (tbuf)) {                                          \
      for (int i_ = 0; i_ < (nph); ++i_) (tbuf)[i_] = (long long)tacc[i_]; \
      (tbuf)[nph] = nbar;                                         \
      (tbuf)[(nph) + 1] = nbar_entry;                             \
    }                                                             \
  } while (0)
#else
#define TIMER_DECL(nph) static_assert(nph > 0, "phases")
#define TIMER_ENTRY() \
  do {                \
  } while (0)
#define STAMP(ph) \
  do {            \
  } while (0)
#define GRID_SYNC() grid.sync()
#define TIMER_WRITE(tbuf, nph) \
  do {                         \
  } while (0)
#endif

// ---- the grid plan (host) ---------------------------------------------------

// S (columns per block), nblk and the SM count for n_pad on the device;
// refuses a device without cooperative launch or a grid over MAX_NBLK.
// Returns a cudaError_t.
inline int grid_plan(int device, int n_pad, int* S, int* nblk, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  *S = (n_pad + *sms - 1) / *sms;
  *nblk = (n_pad + *S - 1) / *S;
  if (*nblk > MAX_NBLK) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// C slab rows: the product's column groups of 8
inline int c_rows(int S) { return S <= 8 ? 8 : 16; }

// partial slots of the entry's Grams and of a gradient phase with a push
inline int gram_npart(int k) {
  const int b = 1 + 2 * k + 2 * k * k, c = 1 + 5 * k;
  return b > c ? b : c;
}

// Sets the kernel's dynamic shared memory and reads how many blocks of it
// fit on an SM. Returns a cudaError_t.
template <typename K>
int smem_setup(K kernel, size_t bytes, int* per_sm) {
  if (bytes > (size_t)SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT,
                                                            bytes);
}

// ---- reductions (fixed order) ----------------------------------------------

template <typename T>
__device__ T warp_sum(T v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A (rows, MAX_S) slab held with row stride rs: in shared memory (rs =
// MAX_S) or in the caller's (rows, n) array from the slab's first column
// (rs = n). Entry e is row e / MAX_S, column e % MAX_S.
template <typename T>
struct Slab {
  T* p;
  int rs;
  __device__ T& operator[](int e) const { return p[(e >> 4) * rs + (e & (MAX_S - 1))]; }
};

// sum of a[e] * b[e] over the valid entries of two (rp, MAX_S) slab arrays
// (columns j < ns; raw shared-memory pointers or Slabs), by one warp; every
// lane returns the same value
template <typename T, typename A, typename B>
__device__ T warp_slab_dot(const A& a, const B& b, int nel, int ns) {
  const int lane = threadIdx.x & 31;
  T s = 0;
  for (int e = lane; e < nel; e += 32)
    if ((e & (MAX_S - 1)) < ns) s += a[e] * b[e];
  return warp_sum(s);
}

// tot[p] = sum over blocks of part[p][b], p < np; the same order in every
// block (lane l adds blocks l, l + 32, ... in turn, then a butterfly).
// Each warp issues the loads of eight slots before it sums any.
// Ends with __syncthreads.
template <typename T>
__device__ void grid_totals(const T* part, int nblk, int np, T* tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  constexpr int U = 8;  // slots per warp turn: 40 loads in flight per lane
  for (int p0 = wid; p0 < np; p0 += U * NW) {
    T s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * NW;
      T a = 0;
#pragma unroll
      for (int i = 0; i < MAX_NBLK / 32; ++i) {
        const int b = lane + 32 * i;
        if (p < np && b < nblk) a += __ldcg(part + (size_t)p * nblk + b);
      }
      s[u] = a;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T v = warp_sum(s[u]);
      const int p = p0 + u * NW;
      if (lane == 0 && p < np) tot[p] = v;
    }
  }
  __syncthreads();
}

// The 32 values v[0..31] of every lane summed over the warp's lanes by
// recursive halving: afterwards v[0] of lane l holds the sum of value l.
template <typename T>
__device__ __forceinline__ void halve32(T* v, int lane) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int q = 0; q < o; ++q) {
      const T send = up ? v[q] : v[q + o];
      const T keep = up ? v[q + o] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

// ---- out[r][j] = sgn . sum_i src[r][i] C[c0 + j][i]  (C symmetric) --------
// src (rp, n) in global memory; out a (rp, MAX_S) slab array, j < ns.
// Warp w takes rows 4 (w & 3) .. +3 of each 16-row pass and the i-lanes
// il = lane + 32 (w >> 2), i = il + 64 c; each thread keeps a 4 x 8 tile
// (8 slab columns per column group) and loads D in batches of DB steps.
// C's slab comes from shared memory (Cs, c_res) or from L2.
template <typename T>
__device__ void cd_product(int n, int rp, const T* C, int c_res,
                           const T* src, T sgn, int c0, int ns, const T* Cs,
                           T* red, T* out) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rg = wid & 3, ih = wid >> 2;
  const int il = lane + 32 * ih;
  const int ncg = (ns + 7) >> 3;
  const int nst = n / IC;
  for (int r0 = 0; r0 < rp; r0 += 16) {
    const int rb = r0 + 4 * rg;  // rp % 8 == 0: rows rb..rb+3 all live or not
    for (int cgi = 0; cgi < ncg; ++cgi) {
      T acc[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) acc[u] = 0;
      if (rb < rp) {
        const T* d0 = src + (size_t)rb * n + il;
        const int jb = cgi * 8;
        const T* cj = c_res ? Cs + (size_t)jb * n + il
                            : C + (size_t)(c0 + jb) * n + il;
        for (int st0 = 0; st0 < nst; st0 += DB) {
          // the batch's D values first: DB x 4 loads in flight per lane
          T dv[DB][4];
#pragma unroll
          for (int s = 0; s < DB; ++s) {
            const int i = (st0 + s) * IC;
#pragma unroll
            for (int a = 0; a < 4; ++a)
              dv[s][a] = st0 + s < nst ? __ldcg(d0 + (size_t)a * n + i) : T(0);
          }
#pragma unroll
          for (int s = 0; s < DB; ++s) {
            if (st0 + s >= nst) break;
            const int i = (st0 + s) * IC;
            T cv[8];
#pragma unroll
            for (int b = 0; b < 8; ++b)
              cv[b] = c_res ? cj[(size_t)b * n + i]
                            : (jb + b < ns ? __ldg(cj + (size_t)b * n + i) : T(0));
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 8; ++b) acc[a * 8 + b] += dv[s][a] * cv[b];
          }
        }
      }
      halve32(acc, lane);
      __syncthreads();  // the previous pass has read red
      red[(ih * 4 + rg) * 32 + lane] = acc[0];
      __syncthreads();
      if (tid < 128) {
        const int g = tid >> 5, l = tid & 31;
        const int r = r0 + 4 * g + (l >> 3), j = cgi * 8 + (l & 7);
        if (r < rp && j < ns)
          out[r * MAX_S + j] = sgn * (red[g * 32 + l] + red[(4 + g) * 32 + l]);
      }
    }
  }
  __syncthreads();
}

// ---- the compact direction's scalars (one thread) --------------------------
// w (2k) from p = [S'g; Y'g], the Grams and rho; slots in age order
// a = 0 (oldest) .. k-1 (newest): slot (head + 1 + a) % k. KK > 0: k == KK,
// every loop unrolled and the k x k system in registers; KK == 0: any
// k <= MAX_K, in local memory.
template <typename T, int KK>
__device__ void compact_w(int k_, int head, const T* rho, const T* STY,
                          const T* YTY, const T* p, T* w) {
  constexpr int KM = KK > 0 ? KK : MAX_K;
  const int k = KK > 0 ? KK : k_;
  T Rm[KM][KM], u[KM], w1[KM];
  int pm[KM];
  bool em[KM];
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (a >= k) break;
    pm[a] = (head + 1 + a) % k;
    em[a] = rho[pm[a]] == T(0);
  }
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (a >= k) break;
#pragma unroll
    for (int b = 0; b < KM; ++b) {
      if (b >= k) break;
      const bool live = !(em[a] || em[b]);
      T v = (b >= a && live) ? STY[pm[a] * k + pm[b]] : T(0);
      if (a == b && em[a]) v = v + T(1);
      Rm[a][b] = v;
    }
  }
  // u = R^-1 S'g (back substitution)
#pragma unroll
  for (int a = KM - 1; a >= 0; --a) {
    if (a >= k) continue;
    T s = p[pm[a]];
#pragma unroll
    for (int b = a + 1; b < KM; ++b) {
      if (b >= k) break;
      s = s - Rm[a][b] * u[b];
    }
    u[a] = s / Rm[a][a];
  }
  // v = D u + Y'Y u - Y'g, then w1 = R^-T v (forward substitution)
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (a >= k) break;
    const bool la = !em[a];
    T v = (la ? STY[pm[a] * k + pm[a]] : T(0)) * u[a];
#pragma unroll
    for (int b = 0; b < KM; ++b) {
      if (b >= k) break;
      const bool live = la && !em[b];
      v = v + (live ? YTY[pm[a] * k + pm[b]] : T(0)) * u[b];
    }
    v = v - p[k + pm[a]];
    T s = v;
#pragma unroll
    for (int b = 0; b < KM; ++b) {
      if (b >= a) break;
      s = s - Rm[b][a] * w1[b];
    }
    w1[a] = s / Rm[a][a];
  }
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (a >= k) break;
    w[pm[a]] = w1[a];
    w[k + pm[a]] = -u[a];
  }
}

template <typename T>
__device__ void compact_w_any(int k, int head, const T* rho, const T* STY,
                              const T* YTY, const T* p, T* w) {
  switch (k) {
    case 1: compact_w<T, 1>(k, head, rho, STY, YTY, p, w); break;
    case 2: compact_w<T, 2>(k, head, rho, STY, YTY, p, w); break;
    case 3: compact_w<T, 3>(k, head, rho, STY, YTY, p, w); break;
    case 4: compact_w<T, 4>(k, head, rho, STY, YTY, p, w); break;
    case 5: compact_w<T, 5>(k, head, rho, STY, YTY, p, w); break;
    case 6: compact_w<T, 6>(k, head, rho, STY, YTY, p, w); break;
    case 7: compact_w<T, 7>(k, head, rho, STY, YTY, p, w); break;
    case 8: compact_w<T, 8>(k, head, rho, STY, YTY, p, w); break;
    default: compact_w<T, 0>(k, head, rho, STY, YTY, p, w);
  }
}

// ---- the gradient-phase dots and the Grams -----------------------------------
// The two slabs whose dot is partial v of the dots the next compact
// direction needs, for warp turn v: 0: g'g; 1..k: S'g; k+1..2k: Y'g; with
// a push of slot jn also 2k+1..3k: s_jn'y_i; 3k+1..4k: s_i'y_jn;
// 4k+1..5k: y_i'y_jn. sr(i) and yr(i) give the ring's slot i as a slab of
// g's type.
template <typename S>
struct DotPair {
  S a, b;
};

template <typename S, typename RingS, typename RingY>
__device__ DotPair<S> grad_operands(int v, int k, int jn, S g, RingS sr,
                                    RingY yr) {
  if (v == 0) return {g, g};
  if (v <= 2 * k) {
    const int i = (v - 1) % k;
    return {v <= k ? sr(i) : yr(i), g};
  }
  const int x = v - 1 - 2 * k, i = x % k, which = x / k;
  if (which == 0) return {sr(jn), yr(i)};
  if (which == 1) return {sr(i), yr(jn)};
  return {yr(i), yr(jn)};
}

// The same for the entry's dots: 0: g'g; 1..2k: S'g and Y'g; then S'Y and
// Y'Y, row-major.
template <typename S, typename RingS, typename RingY>
__device__ DotPair<S> entry_operands(int v, int k, S g, RingS sr, RingY yr) {
  if (v <= 2 * k) return grad_operands(v, k, 0, g, sr, yr);
  const int x = v - 1 - 2 * k;             // STY then YTY, row-major
  const int q = x % (k * k), i = q / k, j = q % k;
  return {x < k * k ? sr(i) : yr(i), yr(j)};
}

}  // namespace
