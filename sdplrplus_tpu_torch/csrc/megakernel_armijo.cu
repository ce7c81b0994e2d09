// K2: the whole inner L-BFGS loop of the inequality families in one
// cooperative launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// sdplrplus_tpu/ops/megakernel.py::_make_kernel_armijo (launched by
// _call_kernel_armijo). Same inputs and outputs as _call_kernel_armijo; the
// Python wrapper is sdplrplus_tpu_torch/ops/megakernel.py::mega_chunk (K2
// when spec.armijo), and mega_chunk_armijo_plain in the same module is this
// loop written step by step in torch.
//
// The problem class: every constraint entry on the diagonal, J <= 4
// diagonal channels per row (each with its own multiplier, weight, rhs and
// multiplier upper bound; +inf for equalities and padding), <= 2 wide
// diagonal constraints (dense weight rows WW), <= 4 low-rank equality
// terms. The merit function is the sharp augmented Lagrangian
//   L = obj + sum (lt^2 - lam^2) / (2 sigma),  lt = min(lam_ub, lam - sigma v)
// over the channels, the wide and the low-rank constraints.
//
// What it computes, per iteration (up to max_steps; exits on ||G|| <= gtol,
// the step budget, or fprec stagnation):
//   1. the two-loop L-BFGS direction over the k-slot (s, y) ring, with a -G
//      fallback when it is not a descent direction; slope0 = <G, D>;
//   2. CDt = D.C, the one n_pad^2 product;
//   3. p1, p2, per-column rv1 = 2 sum_r R.D and rv2 = sum_r D.D, the wide
//      dots q1_w, q2_w and the low-rank contractions D.B;
//   4. Armijo backtracking (c = 1e-4, at most 50 halvings from alpha_max):
//      the sequential loop takes the first t in 0..50 with
//      L(alpha_max 2^-t) <= L + c alpha slope0, else t = 50. L(alpha) is not
//      linear in alpha (the min in lt), so a literal port pays one grid
//      barrier per halving. Instead every block evaluates its slab's
//      channel sum for all 51 candidates in the same pass as step 3 (the
//      channel violations are column-local), the 51 partials ride the
//      line-search barrier, and every block scans t in order afterwards.
//      Halving is exact in binary, so this is the sequential loop's alpha;
//   5. the algebraic commit (channel violations, wide and low-rank
//      violations, obj, Rt, CRt += alpha.CDt, Q), the gradient, ||G||, the
//      stagnation test and the ring push (skipped on stagnation).
// At entry the kernel recomputes L, G and the violations from R.
//
// What bounds it. Per iteration D.C is 2.rp.n_pad^2 FP32 (or FP64) FLOPs:
// 25.7 MFLOP at n_pad = 896 and rp = 16, about 0.38 us at the card's
// 67 TFLOP/s; the 51-candidate pass adds about 51.J.n_pad.6 FLOPs. C is read
// once per launch (it stays in the 50 MB L2). The real limit of this first
// version is latency: every dot is a reduction across the whole grid, and
// the iteration needs 2k + 3 grid-wide barriers (k for each half of the
// two-loop recursion, then the descent test, the line-search dots with the
// Armijo candidates, and the gradient norm), plus two at entry — the same
// count as K1.
//
// What the design does about it (K1's skeleton, csrc/megakernel.cu):
//   * one persistent cooperative grid (one block per SM) for the whole
//     activation; all state stays on the card;
//   * each block owns a slab of S = ceil(n_pad / #SMs) columns of Rt, G,
//     CRt, D, the ring and the J channel rows; C is symmetric, so a block
//     forms CDt[:, slab] from the contiguous rows C[slab, :];
//   * every dot of a phase is batched behind one grid.sync(): each block
//     writes its partials to a double-buffered global array, and after the
//     barrier every block sums all partials in the same fixed order, so all
//     scalars (the dots, alpha, the stagnation flag, the loop exit) are
//     bitwise identical in every block. No atomics: a block that decided
//     differently would wait at the next barrier forever;
//   * plain FP32 (FP64) FMAs, no tensor cores, so no dot is ever TF32.
//
// Data written by one block and read by another inside the launch (the
// partials, the gradient buffers, q) is written with __stcg and read with
// __ldcg, which bypass the non-coherent L1.
//
// The reductions and the D.C product are K1's, repeated here: each kernel
// builds from one self-contained source, whose hash names its library, and
// K1's source stays as it was measured.
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
constexpr int MAX_J = 4;         // diagonal channels per row
constexpr int MAX_W = 2;         // wide constraints
constexpr int N_CAND = 51;       // Armijo candidates alpha_max 2^-t
constexpr int P_QW1 = 2;         // partial slots: p1, p2, q1_w, q2_w, cands
constexpr int P_QW2 = P_QW1 + MAX_W;
constexpr int P_CAND = P_QW2 + MAX_W;
constexpr int N_LS = P_CAND + N_CAND;

}  // namespace

extern "C" {

// Argument block shared with the ctypes wrapper (ops/megakernel.py,
// class _K2Args): keep the field order in step.
struct K2Args {
  int n_pad, rp, k, use_hist;
  int n_lr, n_lc, lrc, is_double;
  int J, n_w;
  int lr_off[MAX_LR + 1];   // column offsets of each term in the lr arrays
  int lr_cons[MAX_LR];      // -1: objective term; else index into lam/b lc
  int device;
  double gscale, alpha_max;
  const void *scal, *C, *Rt_in, *LAM, *W, *B, *UB, *WW;
  void *s_ring, *y_ring;
  const void *lrB, *lrBdt, *lrd;
  void *Rt_out, *G_out, *vio_out, *oscal, *work;
  void *stream;
  // filled in by k2_plan
  int S, nblk, smem_bytes, sms, blocks_per_sm;
  long long work_elems;
};

}  // extern "C"

namespace {

template <typename T>
struct Params {
  int n, rp, k, use_hist, n_lr, n_lc, lrc, J, n_w, S, nblk, npart;
  int lr_off[MAX_LR + 1];
  int lr_cons[MAX_LR];
  T gscale, alpha_max;
  const T *scal, *C, *Rt_in, *LAM, *W, *B, *UB, *WW;
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

// min(ub, x) that keeps a NaN x, as torch.minimum does (fmin drops it)
template <typename T>
__device__ T tmin(T ub, T x) {
  return (x < ub || x != x) ? x : ub;
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
__global__ void __launch_bounds__(NT, 1) k2_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, blk = blockIdx.x;
  const int n = P.n, rp = P.rp, k = P.k, lrc = P.lrc, np = P.npart;
  const int J = P.J, n_w = P.n_w;
  const int c0 = blk * P.S;
  const int ns = min(P.S, n - c0);               // >= 1 by construction
  const int ne = rp * ns;                        // owned elements
  const int nch = J * ns;                        // owned channel entries

  // shared-memory carve-up; slab arrays are (rows, MAX_S) row-major
  const int SL = MAX_RP * MAX_S;
  const int CH = MAX_J * MAX_S;
  T* Rt_s = sm;
  T* CRt_s = Rt_s + SL;
  T* CDt_s = CRt_s + SL;
  T* d_s = CDt_s + SL;
  T* q_s = d_s + SL;
  T* lam_s = q_s + SL;                           // J channel rows
  T* w_s = lam_s + CH;
  T* b_s = w_s + CH;
  T* ub_s = b_s + CH;
  T* vio_s = ub_s + CH;
  T* rv1_s = vio_s + CH;                         // 2 sum_r R.D per column
  T* rv2_s = rv1_s + MAX_S;                      // sum_r D.D per column
  T* mu_s = rv2_s + MAX_S;                       // gradient row multiplier
  T* ww_s = mu_s + MAX_S;                        // MAX_W wide weight rows
  T* cand = ww_s + MAX_W * MAX_S;                // N_CAND candidate steps
  T* Ds = cand + N_CAND;                         // rp x (IC+1)
  T* Cs = Ds + MAX_RP * (IC + 1);                // S x (IC+1)
  T* red = Cs + MAX_S * (IC + 1);                // OPT*NT
  T* tot = red + OPT * NT;                       // npart
  T* Q = tot + N_LS + MAX_RP * MAX_LRC;          // rp x lrc (identical in all blocks)
  T* Qd = Q + MAX_RP * MAX_LRC;
  T* Bs = Qd + MAX_RP * MAX_LRC;                 // S x lrc slab of B
  T* Bdts = Bs + MAX_S * MAX_LRC;                // lrc x S slab of Bdt
  T* rho = Bdts + MAX_LRC * MAX_S;               // k

  const T sigma = P.scal[0];
  const T cur_gtol = P.scal[1];
  const T stag_tol = P.scal[2];
  const int max_steps = (int)P.scal[3];
  int head = (int)P.scal[4];
  const T* lam_lc = P.scal + 5 + k;
  const T* b_lc = lam_lc + P.n_lc;
  const T* lam_w = b_lc + P.n_lc;
  const T* b_w = lam_w + n_w;
  const T* ub_w = b_w + n_w;
  const T half = T(0.5), two = T(2), two_sigma = T(2) * sigma;
  const T c_armijo = T(1e-4);

  // ---- entry: slab state, C.R, Q = R.B ----------------------------------
  for (int e = tid; e < ne; e += NT) {
    int r = e / ns, j = e % ns;
    Rt_s[r * MAX_S + j] = P.Rt_in[(size_t)r * n + c0 + j];
  }
  for (int x = tid; x < nch; x += NT) {
    int ch = x / ns, j = x % ns;
    size_t g = (size_t)ch * n + c0 + j;
    lam_s[ch * MAX_S + j] = P.LAM[g];
    w_s[ch * MAX_S + j] = P.W[g];
    b_s[ch * MAX_S + j] = P.B[g];
    ub_s[ch * MAX_S + j] = P.UB[g];
  }
  for (int x = tid; x < n_w * ns; x += NT) {
    int i = x / ns, j = x % ns;
    ww_s[i * MAX_S + j] = P.WW[(size_t)i * n + c0 + j];
  }
  for (int x = tid; x < ns * lrc; x += NT) {
    int j = x / lrc, c = x % lrc;
    Bs[j * MAX_LRC + c] = P.lrB[(size_t)(c0 + j) * lrc + c];
    Bdts[c * MAX_S + j] = P.lrBdt[(size_t)c * n + c0 + j];
  }
  for (int i = tid; i < k; i += NT) rho[i] = P.scal[5 + i];
  if (tid == 0) {
    T a = P.alpha_max;
    for (int t = 0; t < N_CAND; ++t) {
      cand[t] = a;
      a = a * half;
    }
  }
  cd_product(P, P.Rt_in, T(1), c0, ns, Ds, Cs, red, CRt_s);

  int ph = 0;  // grid barriers passed: selects the partial buffer
  auto pbuf = [&](int phase) { return P.part + (size_t)(phase & 1) * P.nblk * np; };

  // per-column channel violations, the channel sharp-AL sum, wide dots
  T* mypart = pbuf(ph) + (size_t)blk * np;
  {
    T o = 0;
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      o += Rt_s[r * MAX_S + j] * CRt_s[r * MAX_S + j];
    }
    o = block_sum(o, red);
    if (tid == 0) {
      T sh = 0;
      T wv[MAX_W] = {0, 0};
      for (int j = 0; j < ns; ++j) {
        T rv = 0;
        for (int r = 0; r < rp; ++r) rv += Rt_s[r * MAX_S + j] * Rt_s[r * MAX_S + j];
        for (int ch = 0; ch < J; ++ch) {
          int x = ch * MAX_S + j;
          T v = w_s[x] * rv - b_s[x];
          vio_s[x] = v;
          T lt = tmin(ub_s[x], lam_s[x] - sigma * v);
          sh += lt * lt - lam_s[x] * lam_s[x];
        }
        for (int i = 0; i < n_w; ++i) wv[i] += ww_s[i * MAX_S + j] * rv;
      }
      mypart[0] = o;
      mypart[1] = sh;
      for (int i = 0; i < MAX_W; ++i) mypart[P_QW1 + i] = wv[i];
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

  // L's wide and low-rank terms at the given violations
  auto rest_of = [&](const T* vw, const T* vl) {
    T s = 0;
    for (int i = 0; i < n_w; ++i) {
      T lt = tmin(ub_w[i], lam_w[i] - sigma * vw[i]);
      s += (lt * lt - lam_w[i] * lam_w[i]) / two_sigma;
    }
    for (int i = 0; i < P.n_lc; ++i) {
      T lt = lam_lc[i] - sigma * vl[i];
      s = s + (lt * lt - lam_lc[i] * lam_lc[i]) / two_sigma;
    }
    return s;
  };

  T obj = tot[0];
  T vio_lr[MAX_LR], vio_w[MAX_W];
  for (int t = 0; t < P.n_lr; ++t) {
    T tr = lr_tr(Q, Q, t);
    int i = P.lr_cons[t];
    if (i < 0) obj += tr;
    else vio_lr[i] = tr - b_lc[i];
  }
  for (int i = 0; i < n_w; ++i) vio_w[i] = tot[P_QW1 + i] - b_w[i];
  T L_val = obj + tot[1] / two_sigma;
  L_val = L_val + rest_of(vio_w, vio_lr);

  // gradient of the slab into Gdst: 2 (CRt + mu.Rt) + low-rank, with the
  // row multiplier mu = sum_ch W.y_ch + sum_i y_w[i] WW_i, y = -lt
  int cur = 0;
  auto gradient = [&](T* Gdst) {
    for (int j = tid; j < ns; j += NT) {
      T mu = 0;
      for (int ch = 0; ch < J; ++ch) {
        int x = ch * MAX_S + j;
        mu += w_s[x] * -tmin(ub_s[x], lam_s[x] - sigma * vio_s[x]);
      }
      for (int i = 0; i < n_w; ++i)
        mu += -tmin(ub_w[i], lam_w[i] - sigma * vio_w[i]) * ww_s[i * MAX_S + j];
      mu_s[j] = mu;
    }
    __syncthreads();
    for (int e = tid; e < ne; e += NT) {
      int r = e / ns, j = e % ns;
      T g = two * (CRt_s[r * MAX_S + j] + mu_s[j] * Rt_s[r * MAX_S + j]);
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
  T gsq = tot[0];
  T gnorm = sqrt(gsq) / P.gscale;

  int steps = 0;
  bool stag = false;
  T alpha_last = 0;

  // ---- the inner loop -----------------------------------------------------
  while (gnorm > cur_gtol && steps < max_steps && !stag) {
    T* Gc = P.gbuf + (size_t)cur * rp * n;
    T* Gn = P.gbuf + (size_t)(cur ^ 1) * rp * n;
    const T* src = Gc;  // the direction is -src
    T slope0 = -gsq;    // <G, -G>

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
      if (!bad) slope0 = descent;
    }

    // ---- line-search products and the Armijo candidates -------------------
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
      for (int j = tid; j < ns; j += NT) {
        T rd = 0, dd = 0;
        for (int r = 0; r < rp; ++r) {
          rd += Rt_s[r * MAX_S + j] * d_s[r * MAX_S + j];
          dd += d_s[r * MAX_S + j] * d_s[r * MAX_S + j];
        }
        rv1_s[j] = two * rd;
        rv2_s[j] = dd;
      }
      __syncthreads();
      if (tid == 0) {
        T w1[MAX_W] = {0, 0}, w2[MAX_W] = {0, 0};
        for (int j = 0; j < ns; ++j)
          for (int i = 0; i < n_w; ++i) {
            w1[i] += ww_s[i * MAX_S + j] * rv1_s[j];
            w2[i] += ww_s[i * MAX_S + j] * rv2_s[j];
          }
        mypart[0] = two * p1;
        mypart[1] = p2;
        for (int i = 0; i < MAX_W; ++i) {
          mypart[P_QW1 + i] = w1[i];
          mypart[P_QW2 + i] = w2[i];
        }
      }
      // the slab's channel sum of (lt^2 - lam^2) at every candidate step
      for (int t = tid; t < N_CAND; t += NT) {
        T a = cand[t];
        T s = 0;
        for (int ch = 0; ch < J; ++ch)
          for (int j = 0; j < ns; ++j) {
            int x = ch * MAX_S + j;
            T q1 = w_s[x] * rv1_s[j], q2 = w_s[x] * rv2_s[j];
            T lt = tmin(ub_s[x], lam_s[x] - sigma * (vio_s[x] + a * (a * q2 + q1)));
            s += lt * lt - lam_s[x] * lam_s[x];
          }
        mypart[P_CAND + t] = s;
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

    // ---- the Armijo step (every thread, the same bits) --------------------
    T p1 = tot[0], p2 = tot[1];
    T q1_w[MAX_W], q2_w[MAX_W];
    for (int i = 0; i < n_w; ++i) {
      q1_w[i] = tot[P_QW1 + i];
      q2_w[i] = tot[P_QW2 + i];
    }
    T p1_lr[MAX_LR], p2_lr[MAX_LR];
    for (int t = 0; t < P.n_lr; ++t) {
      p1_lr[t] = two * lr_tr(Q, Qd, t);
      p2_lr[t] = lr_tr(Qd, Qd, t);
      if (P.lr_cons[t] < 0) {
        p1 = p1 + p1_lr[t];
        p2 = p2 + p2_lr[t];
      }
    }
    T alpha = 0, L_new = 0;
    for (int t = 0; t < N_CAND; ++t) {
      T a = cand[t];
      T vw[MAX_W], vl[MAX_LR];
      for (int i = 0; i < n_w; ++i) vw[i] = vio_w[i] + a * (a * q2_w[i] + q1_w[i]);
      for (int tt = 0; tt < P.n_lr; ++tt) {
        int i = P.lr_cons[tt];
        if (i >= 0) vl[i] = vio_lr[i] + a * (a * p2_lr[tt] + p1_lr[tt]);
      }
      T L = obj + a * (a * p2 + p1) + tot[P_CAND + t] / two_sigma;
      L = L + rest_of(vw, vl);
      alpha = a;
      L_new = L;
      if (!(L > L_val + c_armijo * a * slope0)) break;
    }

    // ---- algebraic commit ---------------------------------------------------
    for (int x = tid; x < nch; x += NT) {
      int ch = x / ns, j = x % ns;
      int y = ch * MAX_S + j;
      T q1 = w_s[y] * rv1_s[j], q2 = w_s[y] * rv2_s[j];
      vio_s[y] = vio_s[y] + alpha * (alpha * q2 + q1);
    }
    for (int i = 0; i < n_w; ++i) vio_w[i] = vio_w[i] + alpha * (alpha * q2_w[i] + q1_w[i]);
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
    __syncthreads();  // every thread has read Q and Qd for the step
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
    gsq = tot[0];
    T gnorm_new = sqrt(gsq) / P.gscale;
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
  for (int x = tid; x < nch; x += NT) {
    int ch = x / ns, j = x % ns;
    P.vio_out[(size_t)ch * n + c0 + j] = vio_s[ch * MAX_S + j];
  }
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
    const int n_vlr = P.n_lc > 1 ? P.n_lc : 1;
    for (int i = 0; i < n_vlr; ++i) o[7 + k + i] = i < P.n_lc ? vio_lr[i] : T(0);
    for (int i = 0; i < n_w; ++i) o[7 + k + n_vlr + i] = vio_w[i];
  }
}

size_t smem_elems() {
  return 5 * MAX_RP * MAX_S + 5 * MAX_J * MAX_S + 3 * MAX_S + MAX_W * MAX_S +
         N_CAND + (MAX_RP + MAX_S) * (IC + 1) + OPT * NT +
         (N_LS + MAX_RP * MAX_LRC) + 2 * MAX_RP * MAX_LRC + 2 * MAX_S * MAX_LRC +
         MAX_K;
}

template <typename T>
int plan(K2Args* a) {
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
  err = cudaFuncSetAttribute(k2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k2_kernel<T>, NT, smem);
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
int launch(K2Args* a) {
  int rc = plan<T>(a);
  if (rc != 0) return rc;
  if (a->J < 1 || a->J > MAX_J || a->n_w < 0 || a->n_w > MAX_W)
    return (int)cudaErrorInvalidValue;
  Params<T> P;
  P.n = a->n_pad;
  P.rp = a->rp;
  P.k = a->k;
  P.use_hist = a->use_hist;
  P.n_lr = a->n_lr;
  P.n_lc = a->n_lc;
  P.lrc = a->lrc;
  P.J = a->J;
  P.n_w = a->n_w;
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
  P.LAM = (const T*)a->LAM;
  P.W = (const T*)a->W;
  P.B = (const T*)a->B;
  P.UB = (const T*)a->UB;
  P.WW = (const T*)a->WW;
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
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)k2_kernel<T>, dim3(a->nblk),
                                                dim3(NT), args, (size_t)a->smem_bytes,
                                                (cudaStream_t)a->stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it calls in (ops/megakernel.py).
int k2_limits(int* out) {
  out[0] = MAX_RP;
  out[1] = MAX_S;
  out[2] = MAX_K;
  out[3] = MAX_LR;
  out[4] = MAX_LRC;
  out[5] = IC;
  out[6] = MAX_J;
  out[7] = MAX_W;
  out[8] = N_CAND;
  out[9] = (int)sizeof(K2Args);
  return 0;
}

// Fills S, nblk, smem_bytes, sms, blocks_per_sm and work_elems of *a for
// its n_pad, rp, lrc and dtype. Returns a cudaError_t.
int k2_plan(K2Args* a) {
  return a->is_double ? plan<double>(a) : plan<float>(a);
}

// Launches K2 on a->stream; does not synchronise. Returns a cudaError_t
// (the launch's, then cudaGetLastError's).
int k2_launch(K2Args* a) {
  return a->is_double ? launch<double>(a) : launch<float>(a);
}

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
