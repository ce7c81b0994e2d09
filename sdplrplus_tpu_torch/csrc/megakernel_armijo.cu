// K2: the whole inner L-BFGS loop of the inequality families in one
// cooperative launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// sdplrplus_tpu/ops/megakernel.py::_make_kernel_armijo (launched by
// _call_kernel_armijo). Same inputs and outputs as _call_kernel_armijo, plus
// the ring's Gram matrices S'Y and Y'Y; the Python wrapper is
// sdplrplus_tpu_torch/ops/megakernel.py::mega_chunk (K2 when spec.armijo),
// and mega_chunk_armijo_plain in the same module is this loop written step
// by step in torch, with the same compact direction and Gram bookkeeping.
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
//   1. the L-BFGS direction D = -H.G in the Byrd-Nocedal-Schnabel compact
//      form (sdplrplus_tpu/solver/lbfgs.py::_direction_compact, the JAX
//      package's default): with p = [S'g; Y'g] and the k x k Grams S'Y and
//      Y'Y in age order, u = R^-1 S'g, v = D u + Y'Y u - Y'g,
//      w = [R^-T v; -u] and D = -(g + [S Y] w); empty slots (rho = 0) are
//      masked with a unit diagonal. D = -G when <G, D> is not negative or
//      NaN; slope0 = <G, D> = -(g'g + w'p) from scalars;
//   2. CDt = D.C, the one n_pad^2 product;
//   3. p1, p2, per-column rv1 = 2 sum_r R.D and rv2 = sum_r D.D, the wide
//      dots q1_w, q2_w and the low-rank contractions D.B;
//   4. Armijo backtracking (c = 1e-4, at most 50 halvings from alpha_max):
//      the first t in 0..50 with L(alpha_max 2^-t) <= L + c alpha slope0,
//      else t = 50. Every block evaluates its slab's channel sum for all 51
//      candidates (the channel violations are column-local), the partials
//      ride the line-search barrier, and every block scans t in order;
//   5. the algebraic commit (violations, obj, Rt, CRt += alpha.CDt, Q), the
//      gradient, the stagnation test and the ring push (skipped on
//      stagnation), with every partial the next direction needs: ||G||^2,
//      S'g and Y'g over the ring after the push, and the pushed slot's row
//      and column of S'Y and Y'Y (their [j, j] entry is y's, rho = 1/y's).
// At entry the kernel recomputes L, G and the violations from R, and the
// Grams from the ring (their partials ride the entry's gradient barrier).
//
// What bounds it. Per iteration D.C is 2.rp.n_pad^2 FP32 (or FP64) FLOPs:
// 25.7 MFLOP at n_pad = 896 and rp = 16, about 0.38 us at the card's
// 67 TFLOP/s. The real limit is latency: every dot is a reduction across
// the whole grid. The first, two-loop design paid 2k + 3 = 11 grid
// barriers per iteration at k = 4, re-read the ring from L2 in every dot
// and streamed C and D through shared memory in 64-wide synchronous
// chunks (megakernel_armijo_twoloop.cu keeps it, for timing).
//
// What this design does about it:
//   * 3 grid barriers per iteration, whatever k: (a) publish D, (b) the
//     line-search and Armijo partials, (c) the gradient partials, which
//     also carry every dot of the next direction (the compact form needs
//     no dot of its own). After (c) thread 0 of every block solves the
//     k x k triangular systems in the same fixed order, so every scalar (the
//     dots, alpha, the stagnation flag, the loop exit) is bitwise identical
//     in every block, as before. No atomics: a block that decided
//     differently would wait at the next barrier forever. The optional
//     step to 2 barriers (C.D from C.G and rings of C.s and C.y slabs) is
//     not taken: its recurrences change the float32 trajectory;
//   * C's column slab stays in shared memory for the whole launch where it
//     fits (float32 up to n_pad 2048, float64 up to n_pad 896); elsewhere
//     the product reads it from L2 (__ldg) beside D. No element of D is
//     used twice within a block, so D goes straight from L2 into
//     registers, eight 64-column steps at a time (all their loads issued
//     before the first FMA), instead of through a shared-memory copy;
//   * the product keeps a 4 x 8 register tile per thread (4 rows of D
//     times 8 columns of C) over a 64-lane split of the n axis, and sums
//     the 32 values of each warp's tile in 31 shuffles (recursive
//     halving), not 32 x 5;
//   * the ring's slab of s and y, G (current and next) and D live in
//     shared memory for the whole launch; the ring goes back to the
//     caller's arrays at exit;
//   * block partials are stored slot-major, so the 32 lanes that sum one
//     slot read consecutive addresses, and each lane issues the loads of
//     eight slots at once before summing;
//   * after the line-search barrier the 51 Armijo candidates are
//     evaluated one per thread and the first that passes is found by a
//     warp ballot, not by a scan in every thread; one warp per low-rank
//     term forms its products;
//   * the k x k triangular solves run in registers (k <= 8; unrolled for
//     each k);
//   * plain FP32 (FP64) FMAs, no tensor cores, so no dot is ever TF32.
// Tried on the card and not kept, each slower than this form (PERF.md): a
// ticket barrier whose last block alone sums the partials and publishes
// the totals; each block starting the product at another 64-column step;
// the product as a function of its own (__noinline__); blocks starting
// grid_totals at another slot.
//
// Data written by one block and read by another inside the launch (the
// partials, D) is written with __stcg and read with __ldcg, which bypass
// the non-coherent L1. The caller's s and y rings are updated in place.
//
// The reductions, the D.C product, the compact solves, the grid plan and
// the timing stamps are shared with K1: csrc/megakernel_common.cuh.
//
// Timing build (-DK2_TIMING, chip_smoke.py phase 8): thread 0 of block 0
// adds the %globaltimer time between consecutive stamps to its phase's sum
// and counts the grid barriers; at exit it writes the sums (ns), the
// barrier count and the entry barriers to tbuf (int64). k2_phases() names
// the phases. Without the macro the stamps compile to nothing.

#include "megakernel_common.cuh"

namespace {

constexpr int MAX_J = 4;         // diagonal channels per row
constexpr int MAX_W = 2;         // wide constraints
constexpr int N_CAND = 51;       // Armijo candidates alpha_max 2^-t
constexpr int P_QW1 = 2;         // line-search slots: p1, p2, q1_w, q2_w, cands
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
  void *tbuf;     // timing builds: per-phase ns, barriers (int64)
  void *stream;
  // filled in by k2_plan
  int S, nblk, smem_bytes, sms, blocks_per_sm, c_resident;
  long long work_elems;
};

}  // extern "C"

namespace {

template <typename T>
struct Params {
  int n, rp, k, use_hist, n_lr, n_lc, lrc, J, n_w, S, nblk, npart, c_res, cp;
  int lr_off[MAX_LR + 1];
  int lr_cons[MAX_LR];
  T gscale, alpha_max;
  const T *scal, *C, *Rt_in, *LAM, *W, *B, *UB, *WW;
  T *s_ring, *y_ring;
  const T *lrB, *lrBdt, *lrd;
  T *Rt_out, *G_out, *vio_out, *oscal;
  T *dbuf;   // (rp, n): the direction, published for the D.C product
  T *part;   // 2 x npart x nblk: double-buffered block partials, slot-major
  long long *tbuf;
};

// partial slots of the widest phase: the line search, the entry's Grams,
// or the gradient with a push
int npart_for(int rp, int k, int lrc) {
  const int a = N_LS + rp * lrc, b = gram_npart(k);
  return a > b ? a : b;
}

// shared memory of one block, in elements (ops/megakernel.py
// k2_smem_bytes mirrors it)
size_t smem_elems(int n, int rp, int k, int lrc, int S, int resident) {
  return (size_t)(resident ? c_rows(S) * n : 0) +
         (size_t)(6 + 2 * k) * rp * MAX_S + 5 * MAX_J * MAX_S +
         (3 + MAX_W) * MAX_S + N_CAND + 8 * 32 + npart_for(rp, k, lrc) +
         rp * lrc + 2 * MAX_S * MAX_LRC + k + 2 * k * k + 2 * k + 2 +
         N_CAND + 2 * MAX_LR + 2;
}

// the timing build's phases, in tbuf order
constexpr int K2_NPH = 10;
const char* const K2_PHASE_NAMES =
    "direction,d_barrier,dc,linesearch,ls_barrier,ls_totals,armijo,"
    "commit_gradient,grad_barrier,grad_totals";
enum {
  PH_DIR, PH_D_BAR, PH_DC, PH_LS, PH_LS_BAR, PH_LS_TOT, PH_ARMIJO, PH_GRAD,
  PH_GRAD_BAR, PH_GRAD_TOT
};

// min(ub, x) that keeps a NaN x, as torch.minimum does (fmin drops it)
template <typename T>
__device__ T tmin(T ub, T x) {
  return (x < ub || x != x) ? x : ub;
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
  const int nel = rp * MAX_S;                    // slab array entries
  const int nch = J * ns;                        // owned channel entries
  const int nblk = P.nblk;
  TIMER_DECL(K2_NPH);

  // shared-memory carve-up (smem_elems); slab arrays are (rows, MAX_S)
  T* Cs = sm;                                    // cp x n C slab, if resident
  T* Rt_s = Cs + (P.c_res ? (size_t)P.cp * n : 0);
  T* CRt_s = Rt_s + nel;
  T* CDt_s = CRt_s + nel;
  T* d_s = CDt_s + nel;
  T* g_s = d_s + nel;                            // 2 x (rp, MAX_S)
  T* sr_s = g_s + 2 * nel;                       // k x (rp, MAX_S) ring
  T* yr_s = sr_s + (size_t)k * nel;
  const int CH = MAX_J * MAX_S;
  T* lam_s = yr_s + (size_t)k * nel;             // J channel rows
  T* w_s = lam_s + CH;
  T* b_s = w_s + CH;
  T* ub_s = b_s + CH;
  T* vio_s = ub_s + CH;
  T* rv1_s = vio_s + CH;                         // 2 sum_r R.D per column
  T* rv2_s = rv1_s + MAX_S;                      // sum_r D.D per column
  T* mu_s = rv2_s + MAX_S;                       // gradient row multiplier
  T* ww_s = mu_s + MAX_S;                        // MAX_W wide weight rows
  T* cand = ww_s + MAX_W * MAX_S;                // N_CAND candidate steps
  T* red = cand + N_CAND;                        // 8 x 32 product tiles
  T* tot = red + 8 * 32;                         // npart
  T* Q = tot + np;                               // rp x lrc (identical in all blocks)
  T* Bs = Q + rp * lrc;                          // S x lrc slab of B
  T* Bdts = Bs + MAX_S * MAX_LRC;                // lrc x S slab of Bdt
  T* rho = Bdts + MAX_LRC * MAX_S;               // k
  T* STY = rho + k;                              // k x k, slot order
  T* YTY = STY + k * k;
  T* wv = YTY + k * k;                           // 2k compact coefficients
  T* slope_s = wv + 2 * k;                       // slope0, descent-ok flag
  T* Lc = slope_s + 2;                           // L at each Armijo candidate
  T* plr = Lc + N_CAND;                          // 2 x MAX_LR low-rank products
  unsigned* passm = reinterpret_cast<unsigned*>(plr + 2 * MAX_LR);  // 2 ballots

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

  // ---- entry: slab state, ring, C slab, C.R, Q = R.B ---------------------
  for (int e = tid; e < (6 + 2 * k) * nel + 5 * CH + (3 + MAX_W) * MAX_S; e += NT)
    Rt_s[e] = 0;                                 // padded columns stay 0
  if (P.c_res) {
    const int cp = P.cp;
    for (size_t x = tid; x < (size_t)cp * n; x += NT) {
      const int j = (int)(x / n);
      Cs[x] = j < ns ? P.C[(size_t)c0 * n + x] : T(0);
    }
  }
  __syncthreads();
  for (int e = tid; e < nel; e += NT) {
    const int r = e >> 4, j = e & (MAX_S - 1);
    if (j < ns) {
      const size_t g = (size_t)r * n + c0 + j;
      Rt_s[e] = P.Rt_in[g];
      for (int i = 0; i < k; ++i) {
        sr_s[i * nel + e] = P.s_ring[(size_t)i * rp * n + g];
        yr_s[i * nel + e] = P.y_ring[(size_t)i * rp * n + g];
      }
    }
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
  __syncthreads();
  cd_product(n, rp, P.C, P.c_res, P.Rt_in, T(1), c0, ns, Cs, red, CRt_s);

  int ph = 0;  // partial phases passed: selects the partial buffer
  auto slot = [&](int p) -> T* {
    return P.part + ((size_t)(ph & 1) * np + p) * nblk + blk;
  };
  const int lane = tid & 31, wid = tid >> 5;
  // the totals of the partial phase just passed (npu slots) into tot
  auto totals = [&](int npu) {
    grid_totals(P.part + (size_t)(ph & 1) * np * nblk, nblk, npu, tot);
    ++ph;
  };

  // per-column channel violations, the channel sharp-AL sum, wide dots
  {
    T o = warp_slab_dot<T>(Rt_s, CRt_s, nel, ns);
    if (wid == 0 && lane == 0) __stcg(slot(0), o);
    if (tid == 32) {
      T sh = 0;
      T wv_[MAX_W] = {0, 0};
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
        for (int i = 0; i < n_w; ++i) wv_[i] += ww_s[i * MAX_S + j] * rv;
      }
      __stcg(slot(1), sh);
      for (int i = 0; i < MAX_W; ++i) __stcg(slot(P_QW1 + i), wv_[i]);
    }
    for (int x = tid; x < rp * lrc; x += NT) {
      int r = x / lrc, c = x % lrc;
      T s = 0;
      for (int j = 0; j < ns; ++j) s += Rt_s[r * MAX_S + j] * Bs[j * MAX_LRC + c];
      __stcg(slot(N_LS + x), s);
    }
  }
  GRID_SYNC();
  totals(N_LS + rp * lrc);
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

  // gradient of the slab into Gdst (a slab array): 2 (CRt + mu.Rt) +
  // low-rank, with the row multiplier mu = sum_ch W.y_ch + sum_i y_w[i] WW_i,
  // y = -lt
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
    for (int e = tid; e < nel; e += NT) {
      const int r = e >> 4, j = e & (MAX_S - 1);
      if (j >= ns) continue;
      T g = two * (CRt_s[e] + mu_s[j] * Rt_s[e]);
      for (int t = 0; t < P.n_lr; ++t) {
        int i = P.lr_cons[t];
        T y_t = i < 0 ? T(1) : -(lam_lc[i] - sigma * vio_lr[i]);
        T s = 0;
        for (int c = P.lr_off[t]; c < P.lr_off[t + 1]; ++c)
          s += Q[r * lrc + c] * Bdts[c * MAX_S + j];
        g = g + two * y_t * s;
      }
      Gdst[e] = g;
    }
    __syncthreads();
  };
  gradient(g_s);

  // ||G||^2, S'g, Y'g and the Grams from the ring: one value per warp turn
  auto sr = [&](int i) -> const T* { return sr_s + (size_t)i * nel; };
  auto yr = [&](int i) -> const T* { return yr_s + (size_t)i * nel; };
  for (int v = wid; v < 1 + 2 * k + 2 * k * k; v += NW) {
    const DotPair<const T*> ab = entry_operands(v, k, (const T*)g_s, sr, yr);
    const T s = warp_slab_dot<T>(ab.a, ab.b, nel, ns);
    if (lane == 0) __stcg(slot(v), s);
  }
  GRID_SYNC();
  totals(1 + 2 * k + 2 * k * k);
  T gsq = tot[0];
  T gnorm = sqrt(gsq) / P.gscale;
  T* pvec = tot + 1;   // [S'g; Y'g], valid until the next grid_totals
  for (int x = tid; x < k * k; x += NT) {
    STY[x] = tot[1 + 2 * k + x];
    YTY[x] = tot[1 + 2 * k + k * k + x];
  }
  __syncthreads();

  int steps = 0;
  bool stag = false;
  T alpha_last = 0;
  TIMER_ENTRY();

  // ---- the inner loop -----------------------------------------------------
  while (gnorm > cur_gtol && steps < max_steps && !stag) {
    T* Gc = g_s + (size_t)cur * nel;
    T* Gn = g_s + (size_t)(cur ^ 1) * nel;

    // ---- direction (every block the same scalars) -------------------------
    if (tid == 0) {
      T slope = -gsq;     // <G, -G>
      bool hist = false;
      if (P.use_hist) {
        compact_w_any(k, head, rho, STY, YTY, pvec, wv);
        T s = gsq;
        for (int i = 0; i < 2 * k; ++i) s = s + wv[i] * pvec[i];
        const T descent = -s;
        hist = !((descent != descent) || descent >= T(0));
        if (hist) slope = descent;
      }
      slope_s[0] = slope;
      slope_s[1] = hist ? T(1) : T(0);
    }
    __syncthreads();
    const T slope0 = slope_s[0];
    const bool hist = slope_s[1] != T(0);
    for (int e = tid; e < nel; e += NT) {
      const int r = e >> 4, j = e & (MAX_S - 1);
      if (j >= ns) continue;
      T h = Gc[e];
      if (hist) {
        T acc = 0;
        for (int i = 0; i < k; ++i) acc = acc + wv[i] * sr_s[i * nel + e];
        for (int i = 0; i < k; ++i) acc = acc + wv[k + i] * yr_s[i * nel + e];
        h = h + acc;
      }
      d_s[e] = -h;
      __stcg(P.dbuf + (size_t)r * n + c0 + j, -h);
    }
    STAMP(PH_DIR);
    GRID_SYNC();
    STAMP(PH_D_BAR);

    // ---- line-search products and the Armijo candidates -------------------
    cd_product(n, rp, P.C, P.c_res, (const T*)P.dbuf, T(1), c0, ns, Cs, red,
               CDt_s);
    STAMP(PH_DC);
    {
      if (wid == 0) {
        const T p1 = warp_slab_dot<T>(Rt_s, CDt_s, nel, ns);
        if (lane == 0) __stcg(slot(0), two * p1);
      } else if (wid == 1) {
        const T p2 = warp_slab_dot<T>(d_s, CDt_s, nel, ns);
        if (lane == 0) __stcg(slot(1), p2);
      }
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
      if (tid == 64) {
        T w1[MAX_W] = {0, 0}, w2[MAX_W] = {0, 0};
        for (int j = 0; j < ns; ++j)
          for (int i = 0; i < n_w; ++i) {
            w1[i] += ww_s[i * MAX_S + j] * rv1_s[j];
            w2[i] += ww_s[i * MAX_S + j] * rv2_s[j];
          }
        for (int i = 0; i < MAX_W; ++i) {
          __stcg(slot(P_QW1 + i), w1[i]);
          __stcg(slot(P_QW2 + i), w2[i]);
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
        __stcg(slot(P_CAND + t), s);
      }
      for (int x = tid; x < rp * lrc; x += NT) {
        int r = x / lrc, c = x % lrc;
        T s = 0;
        for (int j = 0; j < ns; ++j) s += d_s[r * MAX_S + j] * Bs[j * MAX_LRC + c];
        __stcg(slot(N_LS + x), s);
      }
    }
    STAMP(PH_LS);
    GRID_SYNC();
    STAMP(PH_LS_BAR);
    totals(N_LS + rp * lrc);
    const T* Qd = tot + N_LS;   // valid until the gradient's totals
    STAMP(PH_LS_TOT);

    // the low-rank products, one warp per term and product
    if (wid < 2 * MAX_LR && (wid % MAX_LR) < P.n_lr) {
      const int t = wid % MAX_LR, c_lo = P.lr_off[t];
      const int nc = P.lr_off[t + 1] - c_lo;
      const T* Qa = wid < MAX_LR ? Q : Qd;
      T s_ = 0;
      for (int x = lane; x < rp * nc; x += 32) {
        const int r = x / nc, c = c_lo + x % nc;
        s_ += Qa[r * lrc + c] * Qd[r * lrc + c] * P.lrd[c];
      }
      s_ = warp_sum(s_);
      if (lane == 0) plr[wid] = wid < MAX_LR ? two * s_ : s_;
    }
    __syncthreads();

    // ---- the Armijo step: candidate t on thread t; the first that passes
    // by ballot (every block the same bits) ---------------------------------
    T p1 = tot[0], p2 = tot[1];
    T q1_w[MAX_W], q2_w[MAX_W];
    for (int i = 0; i < n_w; ++i) {
      q1_w[i] = tot[P_QW1 + i];
      q2_w[i] = tot[P_QW2 + i];
    }
    const T* p1_lr = plr;
    const T* p2_lr = plr + MAX_LR;
    for (int t = 0; t < P.n_lr; ++t)
      if (P.lr_cons[t] < 0) {
        p1 = p1 + p1_lr[t];
        p2 = p2 + p2_lr[t];
      }
    if (wid < 2) {
      bool pass = false;
      if (tid < N_CAND) {
        const T a = cand[tid];
        T vw[MAX_W], vl[MAX_LR];
        for (int i = 0; i < n_w; ++i) vw[i] = vio_w[i] + a * (a * q2_w[i] + q1_w[i]);
        for (int tt = 0; tt < P.n_lr; ++tt) {
          int i = P.lr_cons[tt];
          if (i >= 0) vl[i] = vio_lr[i] + a * (a * p2_lr[tt] + p1_lr[tt]);
        }
        T L = obj + a * (a * p2 + p1) + tot[P_CAND + tid] / two_sigma;
        L = L + rest_of(vw, vl);
        Lc[tid] = L;
        pass = !(L > L_val + c_armijo * a * slope0);
      }
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      if (lane == 0) passm[wid] = m;
    }
    __syncthreads();
    const int t_ok = passm[0] ? __ffs(passm[0]) - 1
                   : (passm[1] ? 32 + __ffs(passm[1]) - 1 : N_CAND - 1);
    const T alpha = cand[t_ok], L_new = Lc[t_ok];
    const T rel_delta = (L_val - L_new) /
                        fmax(T(1), fmax(fabs(L_new), fabs(L_val)));
    const bool stag_new = rel_delta < stag_tol;
    const bool push = P.use_hist && !stag_new;
    const int jn = (head + 1) % k;               // the pushed slot
    STAMP(PH_ARMIJO);

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
    for (int e = tid; e < nel; e += NT) {
      if ((e & (MAX_S - 1)) >= ns) continue;
      Rt_s[e] = Rt_s[e] + alpha * d_s[e];
      CRt_s[e] = CRt_s[e] + alpha * CDt_s[e];
    }
    __syncthreads();  // every thread has read Q and Qd for the step
    for (int x = tid; x < rp * lrc; x += NT) Q[x] = Q[x] + alpha * Qd[x];
    __syncthreads();

    // ---- gradient, the ring push and the next direction's dots --------------
    gradient(Gn);
    if (push) {
      T* s_new = sr_s + (size_t)jn * nel;
      T* y_new = yr_s + (size_t)jn * nel;
      for (int e = tid; e < nel; e += NT) {
        if ((e & (MAX_S - 1)) >= ns) continue;
        s_new[e] = alpha * d_s[e];
        y_new[e] = Gn[e] - Gc[e];
      }
      __syncthreads();
    }
    for (int v = wid; v < (push ? 1 + 5 * k : 1 + 2 * k); v += NW) {
      const DotPair<const T*> ab = grad_operands(v, k, jn, (const T*)Gn, sr,
                                                 yr);
      const T s = warp_slab_dot<T>(ab.a, ab.b, nel, ns);
      if (lane == 0) __stcg(slot(v), s);
    }
    STAMP(PH_GRAD);
    GRID_SYNC();
    STAMP(PH_GRAD_BAR);
    totals(push ? 1 + 5 * k : 1 + 2 * k);
    gsq = tot[0];
    const T gnorm_new = sqrt(gsq) / P.gscale;
    if (push) {
      for (int i = tid; i < k; i += NT) {
        STY[jn * k + i] = tot[1 + 2 * k + i];
        STY[i * k + jn] = tot[1 + 3 * k + i];
        YTY[jn * k + i] = tot[1 + 4 * k + i];
        YTY[i * k + jn] = tot[1 + 4 * k + i];
      }
      __syncthreads();
      if (tid == 0) rho[jn] = T(1) / STY[jn * k + jn];
      head = jn;
    }
    __syncthreads();

    L_val = L_new;
    gnorm = gnorm_new;
    stag = stag_new;
    alpha_last = alpha;
    cur ^= 1;
    ++steps;
    STAMP(PH_GRAD_TOT);
  }

  // ---- outputs ----------------------------------------------------------------
  const T* Gf = g_s + (size_t)cur * nel;
  for (int e = tid; e < nel; e += NT) {
    const int r = e >> 4, j = e & (MAX_S - 1);
    if (j >= ns) continue;
    const size_t g = (size_t)r * n + c0 + j;
    P.Rt_out[g] = Rt_s[e];
    P.G_out[g] = Gf[e];
    for (int i = 0; i < k; ++i) {
      P.s_ring[(size_t)i * rp * n + g] = sr_s[i * nel + e];
      P.y_ring[(size_t)i * rp * n + g] = yr_s[i * nel + e];
    }
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
    // the Grams after the launch, slot order
    T* og = o + 7 + k + n_vlr + n_w;
    for (int x = 0; x < k * k; ++x) {
      og[x] = STY[x];
      og[k * k + x] = YTY[x];
    }
  }
  TIMER_WRITE(P.tbuf, K2_NPH);
}

template <typename T>
int plan(K2Args* a) {
  int S = 0, nblk = 0, sms = 0;
  int rc = grid_plan(a->device, a->n_pad, &S, &nblk, &sms);
  if (rc != 0) return rc;
  size_t with_c = smem_elems(a->n_pad, a->rp, a->k, a->lrc, S, 1) * sizeof(T);
  size_t without_c = smem_elems(a->n_pad, a->rp, a->k, a->lrc, S, 0) * sizeof(T);
  int resident = with_c <= (size_t)SMEM_MAX;
  size_t smem_sz = resident ? with_c : without_c;
  int per_sm = 0;
  rc = smem_setup(k2_kernel<T>, smem_sz, &per_sm);
  if (rc != 0) return rc;
  int smem = (int)smem_sz;
  int np = npart_for(a->rp, a->k, a->lrc);
  a->S = S;
  a->nblk = nblk;
  a->smem_bytes = smem;
  a->sms = sms;
  a->blocks_per_sm = per_sm;
  a->c_resident = resident;
  a->work_elems = 1LL * a->rp * a->n_pad + 2LL * nblk * np;
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
  P.npart = npart_for(a->rp, a->k, a->lrc);
  P.c_res = a->c_resident;
  P.cp = c_rows(a->S);
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
  P.tbuf = (long long*)a->tbuf;
  T* work = (T*)a->work;
  P.dbuf = work;
  P.part = work + 1LL * a->rp * a->n_pad;
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

// Fills S, nblk, smem_bytes, sms, blocks_per_sm, c_resident and work_elems
// of *a for its n_pad, rp, k, lrc and dtype. Returns a cudaError_t.
int k2_plan(K2Args* a) {
  return a->is_double ? plan<double>(a) : plan<float>(a);
}

// Launches K2 on a->stream; does not synchronise. Returns a cudaError_t
// (the launch's, then cudaGetLastError's).
int k2_launch(K2Args* a) {
  return a->is_double ? launch<double>(a) : launch<float>(a);
}

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The timing build's phase names, comma-separated, in tbuf order.
const char* k2_phases() { return K2_PHASE_NAMES; }

}  // extern "C"
