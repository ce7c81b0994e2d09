// K1: the whole inner L-BFGS loop of the dense engine in one cooperative
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sdplrplus_tpu/ops/megakernel.py::_make_kernel
// (launched by _call_kernel). Same inputs and outputs as _call_kernel; the
// Python wrapper is sdplrplus_tpu_torch/ops/megakernel.py::mega_chunk, and
// mega_chunk_plain in the same module is this loop written step by step in
// torch.
//
// What it computes, per iteration (up to max_steps; exits on ||G|| <= gtol,
// the step budget, or fprec stagnation):
//   1. the two-loop L-BFGS direction over the k-slot (s, y) ring, with a -G
//      fallback when it is not a descent direction;
//   2. CDt = D.C, the one n_pad^2 product;
//   3. p1, p2, per-column q1 and q2, the Gram of [lam, vio, q1, q2] and the
//      low-rank contractions D.B;
//   4. the exact quartic line search (closed-form cubic + one Newton polish
//      of each stationary point);
//   5. the algebraic commit (vio, obj, Rt, CRt += alpha.CDt, Q), the
//      gradient, ||G||, the stagnation test and the ring push.
//
// What bounds it. Per iteration D.C is 2.rp.n_pad^2 FP32 (or FP64) FLOPs:
// 25.7 MFLOP at n_pad = 896 and rp = 16, about 0.38 us at the card's
// 67 TFLOP/s. C is read once per launch (it stays in the 50 MB L2:
// 3.2 MB f32 at n_pad = 896, 16.8 MB at 2048). The real limit of this first
// version is latency: every dot is a reduction across the whole grid, and
// the iteration needs 2k + 3 grid-wide barriers (k for each half of the
// two-loop recursion, then the descent test, the line-search dots and the
// gradient norm), plus two at entry.
//
// What the design does about it:
//   * one persistent cooperative grid (one block per SM) for the whole
//     activation, so there is one launch per inner activation and no host
//     synchronisation inside it; all state stays on the card;
//   * each block owns a slab of S = ceil(n_pad / #SMs) columns of Rt, G,
//     CRt, D, the ring, vio, q1 and q2; C is symmetric, so a block forms
//     CDt[:, slab] from the contiguous rows C[slab, :], staging D and C
//     through shared memory in chunks of the n axis;
//   * every dot of a phase is batched behind one grid.sync(): each block
//     writes its partials to a double-buffered global array, and after the
//     barrier every block sums all partials in the same fixed order, so all
//     scalars (the dots, alpha, the stagnation flag, the loop exit) are
//     bitwise identical in every block. No atomics: a block that decided
//     differently would wait at the next barrier forever;
//   * plain FP32 (FP64) FMAs, no tensor cores, so no dot is ever TF32.
//
// Data written by one block and read by another inside the launch (the
// partials, the gradient buffers, q) is read with __ldcg, which bypasses
// the non-coherent L1.
//
// The caller's s and y rings are updated in place.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int IC = 64;           // n-axis chunk of the D.C product
constexpr int OPT = 4;           // D.C outputs per thread at most
constexpr int MAX_RP = 64;
constexpr int MAX_S = 16;        // columns per block
constexpr int MAX_K = 16;
constexpr int MAX_LR = 4;        // low-rank terms (MAX_LR_TERMS)
constexpr int MAX_LRC = 8;       // low-rank columns over all terms
constexpr int N_LS = 11;         // line-search scalar partials

}  // namespace

extern "C" {

// Argument block shared with the ctypes wrapper (ops/megakernel.py,
// class _K1Args): keep the field order in step.
struct K1Args {
  int n_pad, rp, k, use_hist;
  int n_lr, n_lc, lrc, is_double;
  int lr_off[MAX_LR + 1];   // column offsets of each term in the lr arrays
  int lr_cons[MAX_LR];      // -1: objective term; else index into lam/b lc
  int device;
  double gscale, alpha_max;
  const void *scal, *C, *Rt_in, *lam, *w, *b;
  void *s_ring, *y_ring;
  const void *lrB, *lrBdt, *lrd;
  void *Rt_out, *G_out, *vio_out, *oscal, *work;
  void *stream;
  // filled in by k1_plan
  int S, nblk, smem_bytes, sms, blocks_per_sm;
  long long work_elems;
};

}  // extern "C"

namespace {

template <typename T>
struct Eps;
template <>
struct Eps<float> { static __device__ float v() { return FLT_EPSILON; } };
template <>
struct Eps<double> { static __device__ double v() { return DBL_EPSILON; } };

template <typename T>
struct Params {
  int n, rp, k, use_hist, n_lr, n_lc, lrc, S, nblk, npart;
  int lr_off[MAX_LR + 1];
  int lr_cons[MAX_LR];
  T gscale, alpha_max;
  const T *scal, *C, *Rt_in, *lam, *w, *b;
  T *s_ring, *y_ring;
  const T *lrB, *lrBdt, *lrd;
  T *Rt_out, *G_out, *vio_out, *oscal;
  T *gbuf;   // 2 x (rp, n): current and next gradient
  T *qbuf;   // (rp, n): two-loop vector q, published for the D.C product
  T *part;   // 2 x nblk x npart: double-buffered block partials
};

int npart_for(int rp, int lrc) { return N_LS + rp * lrc; }

// ---- block- and grid-level reductions (fixed order) ----------------------

template <typename T>
__device__ T warp_sum(T v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  T s = 0;
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}

// tot[p] = sum over blocks of part[b][p], p < np; the same order in every
// block. Ends with __syncthreads.
template <typename T>
__device__ void grid_totals(const T* part, int nblk, int npart, int np, T* tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int p = wid; p < np; p += NW) {
    T s = 0;
    for (int b = lane; b < nblk; b += 32) s += __ldcg(part + (size_t)b * npart + p);
    s = warp_sum(s);
    if (lane == 0) tot[p] = s;
  }
  __syncthreads();
}

// ---- the quartic line search (ops/megakernel.py _minimize_quartic) -------

template <typename T>
__device__ void cubic_roots(T a, T b, T c, T d, T eps, T* r, bool* v) {
  const T one = 1;
  const T pi = T(3.141592653589793);
  T scale = fmax(fmax(fabs(a), fabs(b)), fmax(fabs(c), fabs(d))) + eps;
  bool is_cubic = fabs(a) > eps * scale;
  bool is_quad = fabs(b) > eps * scale;
  T lin_root = -d / (fabs(c) > 0 ? c : one);
  T b_safe = is_quad ? b : one;
  T disc_q = c * c - T(4) * b_safe * d;
  T sq = sqrt(fmax(disc_q, T(0)));
  T quad1 = (-c + sq) / (T(2) * b_safe);
  T quad2 = (-c - sq) / (T(2) * b_safe);
  bool qvalid = disc_q >= 0;
  T a_safe = is_cubic ? a : one;
  T bb = b / a_safe, cc = c / a_safe, dd = d / a_safe;
  T p = cc - bb * bb / T(3);
  T q = T(2) * bb * bb * bb / T(27) - bb * cc / T(3) + dd;
  T shift = -bb / T(3);
  T q2 = q / T(2), p3 = p / T(3);
  T disc = q2 * q2 + p3 * p3 * p3;
  T sdisc = sqrt(fmax(disc, T(0)));
  T single = cbrt(-q / T(2) + sdisc) + cbrt(-q / T(2) - sdisc) + shift;
  T pm = fmin(p, -eps);
  T rr = sqrt(-pm / T(3));
  T cos_arg = fmin(fmax(T(3) * q / (T(2) * pm * rr), T(-1)), T(1));
  T phi = acos(cos_arg);
  T t0 = T(2) * rr * cos(phi / T(3)) + shift;
  T t1 = T(2) * rr * cos((phi - T(2) * pi) / T(3)) + shift;
  T t2 = T(2) * rr * cos((phi - T(4) * pi) / T(3)) + shift;
  bool one_real = disc > 0;
  T c0 = one_real ? single : t0, c1 = one_real ? single : t1;
  T c2 = one_real ? single : t2;
  r[0] = is_cubic ? c0 : (is_quad ? quad1 : lin_root);
  r[1] = is_cubic ? c1 : quad2;
  r[2] = c2;
  v[0] = is_cubic || !is_quad;
  v[1] = is_cubic ? !one_real : (is_quad && qvalid);
  v[2] = is_cubic ? !one_real : false;
}

// argmin over [0, amax] of e + d1 x + c1 x^2 + b1 x^3 + a1 x^4
template <typename T>
__device__ void minimize_quartic(T e, T d1, T c1, T b1, T a1, T amax, T eps,
                                 T* alpha, T* fbest) {
  T r[3];
  bool v[3];
  cubic_roots(T(4) * a1, T(3) * b1, T(2) * c1, d1, eps, r, v);
  T cands[5];
  for (int i = 0; i < 3; ++i) {
    T x = r[i];
    T fp = d1 + x * (T(2) * c1 + x * (T(3) * b1 + x * T(4) * a1));
    T fpp = T(2) * c1 + x * (T(6) * b1 + x * T(12) * a1);
    bool ok = fabs(fpp) > eps;
    T pol = ok ? x - fp / fpp : x;
    T cnd = v[i] ? pol : T(0);
    cands[i] = fmin(fmax(cnd, T(0)), amax);
  }
  cands[3] = amax;
  cands[4] = 0;
  T ba = cands[0];
  T x = ba;
  T bf = e + x * (d1 + x * (c1 + x * (b1 + x * a1)));
  for (int i = 1; i < 5; ++i) {
    x = cands[i];
    T f = e + x * (d1 + x * (c1 + x * (b1 + x * a1)));
    if (f < bf) { ba = x; bf = f; }
  }
  *alpha = ba;
  *fbest = bf;
}

// ---- CDt[:, slab] = (sgn . src) @ C[:, slab]  (C symmetric) ---------------

template <typename T>
__device__ void cd_product(const Params<T>& P, const T* src, T sgn, int c0,
                           int ns, T* Ds, T* Cs, T* red, T* out) {
  const int tid = threadIdx.x, n = P.n, rp = P.rp;
  const int no = rp * ns;                        // outputs (r, j)
  int tpo = NT / no;                             // threads per output
  if (tpo < 1) tpo = 1;
  const int items = no * tpo;
  T acc[OPT];
  for (int u = 0; u < OPT; ++u) acc[u] = 0;
  for (int i0 = 0; i0 < n; i0 += IC) {
    __syncthreads();
    for (int x = tid; x < rp * IC; x += NT) {
      int r = x / IC, ii = x % IC;
      Ds[r * (IC + 1) + ii] = __ldcg(src + (size_t)r * n + i0 + ii);
    }
    for (int x = tid; x < ns * IC; x += NT) {
      int j = x / IC, ii = x % IC;
      Cs[j * (IC + 1) + ii] = P.C[(size_t)(c0 + j) * n + i0 + ii];
    }
    __syncthreads();
    for (int u = 0; u < OPT; ++u) {
      int it = tid + u * NT;
      if (it >= items) break;
      int o = it / tpo, sub = it % tpo;
      int r = o / ns, j = o % ns;
      const T* dr = Ds + r * (IC + 1);
      const T* cj = Cs + j * (IC + 1);
      T s = acc[u];
      for (int ii = sub; ii < IC; ii += tpo) s += dr[ii] * cj[ii];
      acc[u] = s;
    }
  }
  __syncthreads();
  for (int u = 0; u < OPT; ++u) {
    int it = tid + u * NT;
    if (it < items) red[it] = acc[u];
  }
  __syncthreads();
  for (int o = tid; o < no; o += NT) {
    T s = 0;
    for (int sub = 0; sub < tpo; ++sub) s += red[o * tpo + sub];
    out[(o / ns) * MAX_S + (o % ns)] = sgn * s;
  }
  __syncthreads();
}

// ---- the kernel -----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 1) k1_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, blk = blockIdx.x;
  const int n = P.n, rp = P.rp, k = P.k, lrc = P.lrc, np = P.npart;
  const int c0 = blk * P.S;
  const int ns = min(P.S, n - c0);               // >= 1 by construction
  const int ne = rp * ns;                        // owned elements

  // shared-memory carve-up; slab arrays are (rp, MAX_S) row-major
  const int SL = MAX_RP * MAX_S;
  T* Rt_s = sm;
  T* CRt_s = Rt_s + SL;
  T* CDt_s = CRt_s + SL;
  T* d_s = CDt_s + SL;
  T* q_s = d_s + SL;
  T* vio_s = q_s + SL;
  T* q1_s = vio_s + MAX_S;
  T* q2_s = q1_s + MAX_S;
  T* lam_s = q2_s + MAX_S;
  T* w_s = lam_s + MAX_S;
  T* b_s = w_s + MAX_S;
  T* Ds = b_s + MAX_S;                           // rp x (IC+1)
  T* Cs = Ds + MAX_RP * (IC + 1);                // S x (IC+1)
  T* red = Cs + MAX_S * (IC + 1);                // OPT*NT
  T* tot = red + OPT * NT;                       // npart
  T* Q = tot + N_LS + MAX_RP * MAX_LRC;          // rp x lrc (identical in all blocks)
  T* Qd = Q + MAX_RP * MAX_LRC;
  T* Bs = Qd + MAX_RP * MAX_LRC;                 // S x lrc slab of B
  T* Bdts = Bs + MAX_S * MAX_LRC;                // lrc x S slab of Bdt
  T* rho = Bdts + MAX_LRC * MAX_S;               // k

  const T eps = Eps<T>::v();
  const T sigma = P.scal[0];
  const T cur_gtol = P.scal[1];
  const T stag_tol = P.scal[2];
  const int max_steps = (int)P.scal[3];
  int head = (int)P.scal[4];
  const T* lam_lc = P.scal + 5 + k;
  const T* b_lc = lam_lc + P.n_lc;
  const T half = T(0.5), two = T(2);

  // ---- entry: slab state, C.R, Q = R.B ----------------------------------
  for (int e = tid; e < ne; e += NT) {
    int r = e / ns, j = e % ns;
    Rt_s[r * MAX_S + j] = P.Rt_in[(size_t)r * n + c0 + j];
  }
  for (int j = tid; j < ns; j += NT) {
    lam_s[j] = P.lam[c0 + j];
    w_s[j] = P.w[c0 + j];
    b_s[j] = P.b[c0 + j];
  }
  for (int x = tid; x < ns * lrc; x += NT) {
    int j = x / lrc, c = x % lrc;
    Bs[j * MAX_LRC + c] = P.lrB[(size_t)(c0 + j) * lrc + c];
    Bdts[c * MAX_S + j] = P.lrBdt[(size_t)c * n + c0 + j];
  }
  for (int i = tid; i < k; i += NT) rho[i] = P.scal[5 + i];
  cd_product(P, P.Rt_in, T(1), c0, ns, Ds, Cs, red, CRt_s);

  int ph = 0;  // grid barriers passed: selects the partial buffer
  auto pbuf = [&](int phase) { return P.part + (size_t)(phase & 1) * P.nblk * np; };

  // per-column violation and the (lam, vio) dots
  T* mypart = pbuf(ph) + (size_t)blk * np;
  {
    T o = 0;
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      o += Rt_s[r * MAX_S + j] * CRt_s[r * MAX_S + j];
    }
    o = block_sum(o, red);
    if (tid == 0) {
      T lv = 0, vv = 0;
      for (int j = 0; j < ns; ++j) {
        T s = 0;
        for (int r = 0; r < rp; ++r) s += Rt_s[r * MAX_S + j] * Rt_s[r * MAX_S + j];
        T v = w_s[j] * s - b_s[j];
        vio_s[j] = v;
        lv += lam_s[j] * v;
        vv += v * v;
      }
      mypart[0] = o;
      mypart[1] = lv;
      mypart[2] = vv;
    }
    for (int x = tid; x < rp * lrc; x += NT) {
      int r = x / lrc, c = x % lrc;
      T s = 0;
      for (int j = 0; j < ns; ++j) s += Rt_s[r * MAX_S + j] * Bs[j * MAX_LRC + c];
      mypart[N_LS + x] = s;
    }
  }
  grid.sync();
  grid_totals(pbuf(ph), P.nblk, np, N_LS + rp * lrc, tot);
  ++ph;
  for (int x = tid; x < rp * lrc; x += NT) Q[x] = tot[N_LS + x];
  __syncthreads();

  // low-rank trace term sum_{r, c in t} Qa Qb d
  auto lr_tr = [&](const T* Qa, const T* Qb, int t) {
    T s = 0;
    for (int r = 0; r < rp; ++r)
      for (int c = P.lr_off[t]; c < P.lr_off[t + 1]; ++c)
        s += Qa[r * lrc + c] * Qb[r * lrc + c] * P.lrd[c];
    return s;
  };

  T obj = tot[0];
  T vio_lr[MAX_LR];
  for (int t = 0; t < P.n_lr; ++t) {
    T tr = lr_tr(Q, Q, t);
    int i = P.lr_cons[t];
    if (i < 0) obj += tr;
    else vio_lr[i] = tr - b_lc[i];
  }
  T L_val = obj - tot[1] + half * sigma * tot[2];
  for (int i = 0; i < P.n_lc; ++i)
    L_val = L_val - lam_lc[i] * vio_lr[i] + half * sigma * vio_lr[i] * vio_lr[i];

  // gradient of the slab into gbuf[cur]: 2 (CRt + (w.y) Rt) + low-rank
  int cur = 0;
  auto gradient = [&](T* Gdst) {
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      T y_row = -(lam_s[j] - sigma * vio_s[j]);
      T g = two * (CRt_s[r * MAX_S + j] + (w_s[j] * y_row) * Rt_s[r * MAX_S + j]);
      for (int t = 0; t < P.n_lr; ++t) {
        int i = P.lr_cons[t];
        T y_t = i < 0 ? T(1) : -(lam_lc[i] - sigma * vio_lr[i]);
        T s = 0;
        for (int c = P.lr_off[t]; c < P.lr_off[t + 1]; ++c)
          s += Q[r * lrc + c] * Bdts[c * MAX_S + j];
        g = g + two * y_t * s;
      }
      __stcg(Gdst + (size_t)r * n + c0 + j, g);
    }
  };
  gradient(P.gbuf);
  {
    T gg = 0;
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      T g = __ldcg(P.gbuf + (size_t)r * n + c0 + j);
      gg += g * g;
    }
    gg = block_sum(gg, red);
    if (tid == 0) pbuf(ph)[(size_t)blk * np] = gg;
  }
  grid.sync();
  grid_totals(pbuf(ph), P.nblk, np, 1, tot);
  ++ph;
  T gnorm = sqrt(tot[0]) / P.gscale;

  int steps = 0;
  bool stag = false;
  T alpha_last = 0;

  // ---- the inner loop -----------------------------------------------------
  while (gnorm > cur_gtol && steps < max_steps && !stag) {
    T* Gc = P.gbuf + (size_t)cur * rp * n;
    T* Gn = P.gbuf + (size_t)(cur ^ 1) * rp * n;
    const T* src = Gc;  // the direction is -src

    if (P.use_hist) {
      // two-loop recursion over the ring (own slab; one barrier per dot)
      for (int e = tid; e < ne; e += NT) {
        int r = e / ns, j = e % ns;
        q_s[r * MAX_S + j] = __ldcg(Gc + (size_t)r * n + c0 + j);
      }
      T a_vals[MAX_K];
      for (int pass = 0; pass < 2; ++pass) {
        for (int i = 0; i < k; ++i) {
          // backward: jj = head - i; forward: the same slots in reverse
          int ii = pass == 0 ? i : k - 1 - i;
          int jj = ((head - ii) % k + k) % k;
          const T* sj = P.s_ring + (size_t)jj * rp * n;
          const T* yj = P.y_ring + (size_t)jj * rp * n;
          const T* dj = pass == 0 ? sj : yj;
          __syncthreads();
          T s = 0;
          for (int e = tid; e < ne; e += NT) {
            int r = e / ns, j = e % ns;
            s += dj[(size_t)r * n + c0 + j] * q_s[r * MAX_S + j];
          }
          s = block_sum(s, red);
          if (tid == 0) pbuf(ph)[(size_t)blk * np] = s;
          grid.sync();
          grid_totals(pbuf(ph), P.nblk, np, 1, tot);
          ++ph;
          T dot = tot[0];
          if (pass == 0) {
            T a = rho[jj] * dot;
            a_vals[ii] = a;
            for (int e = tid; e < ne; e += NT) {
              int r = e / ns, j = e % ns;
              q_s[r * MAX_S + j] = q_s[r * MAX_S + j] - a * yj[(size_t)r * n + c0 + j];
            }
          } else {
            T bq = rho[jj] * dot;
            T coef = a_vals[ii] - bq;
            for (int e = tid; e < ne; e += NT) {
              int r = e / ns, j = e % ns;
              q_s[r * MAX_S + j] = q_s[r * MAX_S + j] + coef * sj[(size_t)r * n + c0 + j];
            }
          }
        }
      }
      // publish q; the descent test <-q, G>
      __syncthreads();
      T s = 0;
      for (int e = tid; e < ne; e += NT) {
        int r = e / ns, j = e % ns;
        T qv = q_s[r * MAX_S + j];
        __stcg(P.qbuf + (size_t)r * n + c0 + j, qv);
        s += (-qv) * __ldcg(Gc + (size_t)r * n + c0 + j);
      }
      s = block_sum(s, red);
      if (tid == 0) pbuf(ph)[(size_t)blk * np] = s;
      grid.sync();
      grid_totals(pbuf(ph), P.nblk, np, 1, tot);
      ++ph;
      T descent = tot[0];
      bool bad = (descent != descent) || descent >= T(0);
      src = bad ? Gc : P.qbuf;
    }

    // ---- line-search products ---------------------------------------------
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      d_s[r * MAX_S + j] = -__ldcg(src + (size_t)r * n + c0 + j);
    }
    cd_product(P, src, T(-1), c0, ns, Ds, Cs, red, CDt_s);
    mypart = pbuf(ph) + (size_t)blk * np;
    {
      T p1 = 0, p2 = 0;
      for (int e = tid; e < ne; e += NT) {
        int r = e / ns, j = e % ns;
        int x = r * MAX_S + j;
        p1 += Rt_s[x] * CDt_s[x];
        p2 += d_s[x] * CDt_s[x];
      }
      p1 = block_sum(p1, red);
      p2 = block_sum(p2, red);
      if (tid == 0) {
        T g[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        for (int j = 0; j < ns; ++j) {
          T rd = 0, dd = 0;
          for (int r = 0; r < rp; ++r) {
            rd += Rt_s[r * MAX_S + j] * d_s[r * MAX_S + j];
            dd += d_s[r * MAX_S + j] * d_s[r * MAX_S + j];
          }
          T q1 = two * w_s[j] * rd, q2 = w_s[j] * dd;
          q1_s[j] = q1;
          q2_s[j] = q2;
          T l = lam_s[j], v = vio_s[j];
          g[0] += l * v;   g[1] += v * v;
          g[2] += l * q1;  g[3] += v * q1;
          g[4] += l * q2;  g[5] += v * q2;
          g[6] += q1 * q1; g[7] += q1 * q2; g[8] += q2 * q2;
        }
        mypart[0] = two * p1;
        mypart[1] = p2;
        for (int i = 0; i < 9; ++i) mypart[2 + i] = g[i];
      }
      for (int x = tid; x < rp * lrc; x += NT) {
        int r = x / lrc, c = x % lrc;
        T s = 0;
        for (int j = 0; j < ns; ++j) s += d_s[r * MAX_S + j] * Bs[j * MAX_LRC + c];
        mypart[N_LS + x] = s;
      }
    }
    grid.sync();
    grid_totals(pbuf(ph), P.nblk, np, N_LS + rp * lrc, tot);
    ++ph;
    for (int x = tid; x < rp * lrc; x += NT) Qd[x] = tot[N_LS + x];
    __syncthreads();

    // ---- quartic coefficients and the line search (every thread) --------
    T p1 = tot[0], p2 = tot[1];
    const T* Gm = tot + 2;  // lv, vv, lq1, vq1, lq2, vq2, q1q1, q1q2, q2q2
    T p1_lr[MAX_LR], p2_lr[MAX_LR];
    for (int t = 0; t < P.n_lr; ++t) {
      p1_lr[t] = two * lr_tr(Q, Qd, t);
      p2_lr[t] = lr_tr(Qd, Qd, t);
      if (P.lr_cons[t] < 0) {
        p1 = p1 + p1_lr[t];
        p2 = p2 + p2_lr[t];
      }
    }
    T ce = obj - Gm[0] + half * sigma * Gm[1];
    T cd = p1 - Gm[2] + sigma * Gm[3];
    T cc = p2 - Gm[4] + sigma * Gm[5] + half * sigma * Gm[6];
    T cb = sigma * Gm[7];
    T ca = half * sigma * Gm[8];
    for (int t = 0; t < P.n_lr; ++t) {
      int i = P.lr_cons[t];
      if (i < 0) continue;
      T lq1 = p1_lr[t], lq2 = p2_lr[t], lv = vio_lr[i];
      ce = ce - lam_lc[i] * lv + half * sigma * lv * lv;
      cd = cd - lam_lc[i] * lq1 + sigma * lv * lq1;
      cc = cc - lam_lc[i] * lq2 + sigma * lv * lq2 + half * sigma * lq1 * lq1;
      cb = cb + sigma * lq1 * lq2;
      ca = ca + half * sigma * lq2 * lq2;
    }
    T alpha, L_new;
    minimize_quartic(ce, cd, cc, cb, ca, P.alpha_max, eps, &alpha, &L_new);

    // ---- algebraic commit ---------------------------------------------------
    for (int j = tid; j < ns; j += NT)
      vio_s[j] = vio_s[j] + alpha * (alpha * q2_s[j] + q1_s[j]);
    for (int t = 0; t < P.n_lr; ++t) {
      int i = P.lr_cons[t];
      if (i >= 0) vio_lr[i] = vio_lr[i] + alpha * (alpha * p2_lr[t] + p1_lr[t]);
    }
    obj = obj + alpha * (alpha * p2 + p1);
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      int x = r * MAX_S + j;
      Rt_s[x] = Rt_s[x] + alpha * d_s[x];
      CRt_s[x] = CRt_s[x] + alpha * CDt_s[x];
    }
    __syncthreads();  // every thread has read Q and Qd for the coefficients
    for (int x = tid; x < rp * lrc; x += NT) Q[x] = Q[x] + alpha * Qd[x];
    __syncthreads();

    // ---- gradient, ||G||^2 and y's ------------------------------------------
    gradient(Gn);
    mypart = pbuf(ph) + (size_t)blk * np;
    {
      T gg = 0, ys = 0;
      for (int e = tid; e < ne; e += NT) {
        int r = e / ns, j = e % ns;
        size_t g = (size_t)r * n + c0 + j;
        T gn = __ldcg(Gn + g);
        gg += gn * gn;
        ys += (gn - __ldcg(Gc + g)) * (alpha * d_s[r * MAX_S + j]);
      }
      gg = block_sum(gg, red);
      ys = block_sum(ys, red);
      if (tid == 0) {
        mypart[0] = gg;
        mypart[1] = ys;
      }
    }
    grid.sync();
    grid_totals(pbuf(ph), P.nblk, np, 2, tot);
    ++ph;
    T gnorm_new = sqrt(tot[0]) / P.gscale;
    T ys = tot[1];

    T rel_delta = (L_val - L_new) /
                  fmax(T(1), fmax(fabs(L_new), fabs(L_val)));
    bool stag_new = rel_delta < stag_tol;

    if (P.use_hist && !stag_new) {
      int head_new = (head + 1) % k;
      T* sdst = P.s_ring + (size_t)head_new * rp * n;
      T* ydst = P.y_ring + (size_t)head_new * rp * n;
      for (int e = tid; e < ne; e += NT) {
        int r = e / ns, j = e % ns;
        size_t g = (size_t)r * n + c0 + j;
        sdst[g] = alpha * d_s[r * MAX_S + j];
        ydst[g] = __ldcg(Gn + g) - __ldcg(Gc + g);
      }
      __syncthreads();
      if (tid == 0) rho[head_new] = T(1) / ys;
      head = head_new;
    }
    __syncthreads();

    L_val = L_new;
    gnorm = gnorm_new;
    stag = stag_new;
    alpha_last = alpha;
    cur ^= 1;
    ++steps;
  }

  // ---- outputs ----------------------------------------------------------------
  const T* Gf = P.gbuf + (size_t)cur * rp * n;
  for (int e = tid; e < ne; e += NT) {
    int r = e / ns, j = e % ns;
    size_t g = (size_t)r * n + c0 + j;
    P.Rt_out[g] = Rt_s[r * MAX_S + j];
    P.G_out[g] = __ldcg(Gf + g);
  }
  for (int j = tid; j < ns; j += NT) P.vio_out[c0 + j] = vio_s[j];
  if (blk == 0 && tid == 0) {
    T* o = P.oscal;
    o[0] = L_val;
    o[1] = obj;
    o[2] = gnorm;
    o[3] = (T)steps;
    o[4] = stag ? T(1) : T(0);
    o[5] = alpha_last;
    o[6] = (T)head;
    for (int i = 0; i < k; ++i) o[7 + i] = rho[i];
    for (int i = 0; i < (P.n_lc > 1 ? P.n_lc : 1); ++i)
      o[7 + k + i] = i < P.n_lc ? vio_lr[i] : T(0);
  }
}

size_t smem_elems() {
  return 5 * MAX_RP * MAX_S + 6 * MAX_S + (MAX_RP + MAX_S) * (IC + 1) +
         OPT * NT + (N_LS + MAX_RP * MAX_LRC) + 2 * MAX_RP * MAX_LRC +
         2 * MAX_S * MAX_LRC + MAX_K;
}

template <typename T>
int plan(K1Args* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a->device);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, a->device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  int S = (a->n_pad + sms - 1) / sms;
  int nblk = (a->n_pad + S - 1) / S;
  int smem = (int)(smem_elems() * sizeof(T));
  err = cudaFuncSetAttribute(k1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1_kernel<T>, NT, smem);
  if (err != cudaSuccess) return (int)err;
  int np = npart_for(a->rp, a->lrc);
  a->S = S;
  a->nblk = nblk;
  a->smem_bytes = smem;
  a->sms = sms;
  a->blocks_per_sm = per_sm;
  a->work_elems = 3LL * a->rp * a->n_pad + 2LL * nblk * np;
  return 0;
}

template <typename T>
int launch(K1Args* a) {
  int rc = plan<T>(a);
  if (rc != 0) return rc;
  Params<T> P;
  P.n = a->n_pad;
  P.rp = a->rp;
  P.k = a->k;
  P.use_hist = a->use_hist;
  P.n_lr = a->n_lr;
  P.n_lc = a->n_lc;
  P.lrc = a->lrc;
  P.S = a->S;
  P.nblk = a->nblk;
  P.npart = npart_for(a->rp, a->lrc);
  for (int i = 0; i <= MAX_LR; ++i) P.lr_off[i] = a->lr_off[i];
  for (int i = 0; i < MAX_LR; ++i) P.lr_cons[i] = a->lr_cons[i];
  P.gscale = (T)a->gscale;
  P.alpha_max = (T)a->alpha_max;
  P.scal = (const T*)a->scal;
  P.C = (const T*)a->C;
  P.Rt_in = (const T*)a->Rt_in;
  P.lam = (const T*)a->lam;
  P.w = (const T*)a->w;
  P.b = (const T*)a->b;
  P.s_ring = (T*)a->s_ring;
  P.y_ring = (T*)a->y_ring;
  P.lrB = (const T*)a->lrB;
  P.lrBdt = (const T*)a->lrBdt;
  P.lrd = (const T*)a->lrd;
  P.Rt_out = (T*)a->Rt_out;
  P.G_out = (T*)a->G_out;
  P.vio_out = (T*)a->vio_out;
  P.oscal = (T*)a->oscal;
  T* work = (T*)a->work;
  P.gbuf = work;
  P.qbuf = work + 2LL * a->rp * a->n_pad;
  P.part = work + 3LL * a->rp * a->n_pad;
  void* args[] = {&P};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)k1_kernel<T>, dim3(a->nblk),
                                                dim3(NT), args, (size_t)a->smem_bytes,
                                                (cudaStream_t)a->stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it calls in (ops/megakernel.py).
int k1_limits(int* out) {
  out[0] = MAX_RP;
  out[1] = MAX_S;
  out[2] = MAX_K;
  out[3] = MAX_LR;
  out[4] = MAX_LRC;
  out[5] = IC;
  out[6] = (int)sizeof(K1Args);
  return 0;
}

// Fills S, nblk, smem_bytes, sms, blocks_per_sm and work_elems of *a for
// its n_pad, rp, lrc and dtype. Returns a cudaError_t.
int k1_plan(K1Args* a) {
  return a->is_double ? plan<double>(a) : plan<float>(a);
}

// Launches K1 on a->stream; does not synchronise. Returns a cudaError_t
// (the launch's, then cudaGetLastError's).
int k1_launch(K1Args* a) {
  return a->is_double ? launch<double>(a) : launch<float>(a);
}

const char* k1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
