// K1: the whole inner L-BFGS loop of the dense engine in one cooperative
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sdplrplus_tpu/ops/megakernel.py::_make_kernel
// (launched by _call_kernel). Same inputs and outputs as _call_kernel, plus
// the ring's Gram matrices S'Y and Y'Y; the Python wrapper is
// sdplrplus_tpu_torch/ops/megakernel.py::mega_chunk, and mega_chunk_plain
// in the same module is this loop written step by step in torch, with the
// same compact direction and Gram bookkeeping.
//
// What it computes, per iteration (up to max_steps; exits on ||G|| <= gtol,
// the step budget, or fprec stagnation):
//   1. the L-BFGS direction D = -H.G in the Byrd-Nocedal-Schnabel compact
//      form (sdplrplus_tpu/solver/lbfgs.py::_direction_compact, the JAX
//      package's default): with p = [S'g; Y'g] and the k x k Grams S'Y and
//      Y'Y in age order, u = R^-1 S'g, v = D u + Y'Y u - Y'g,
//      w = [R^-T v; -u] and D = -(g + [S Y] w); empty slots (rho = 0) are
//      masked with a unit diagonal. D = -G when <G, D> = -(g'g + w'p) is
//      not negative or NaN;
//   2. CDt = D.C, the one n_pad^2 product;
//   3. p1, p2, per-column q1 = 2 w sum_r R.D and q2 = w sum_r D.D, the
//      Gram of [lam, vio, q1, q2] and the low-rank contractions D.B;
//   4. the exact quartic line search (closed-form cubic + one Newton polish
//      of each stationary point), solved by every thread from the same
//      totals;
//   5. the algebraic commit (vio, obj, Rt, CRt += alpha.CDt, Q), the
//      gradient, the stagnation test and the ring push (skipped on
//      stagnation), with every partial the next direction needs: ||G||^2,
//      S'g and Y'g over the ring after the push, and the pushed slot's row
//      and column of S'Y and Y'Y (their [j, j] entry is y's, rho = 1/y's).
// At entry the kernel recomputes L, G and the violations from R, and the
// Grams from the ring (their partials ride the entry's gradient barrier),
// so it takes any LBFGSState the major loop holds.
//
// What bounds it. Per iteration D.C is 2.rp.n_pad^2 FP32 (or FP64) FLOPs:
// 25.7 MFLOP at n_pad = 896 and rp = 16, about 0.38 us at the card's
// 67 TFLOP/s. C is read once per launch (it stays in the 50 MB L2:
// 3.2 MB f32 at n_pad = 896, 16.8 MB at 2048). The real limit is latency:
// every dot is a reduction across the whole grid. The first, two-loop
// design paid 2k + 3 = 11 grid barriers per iteration at k = 4, re-read
// the ring from L2 in every dot and streamed C and D through shared memory
// in 64-wide synchronous chunks (megakernel_twoloop.cu keeps it, for
// timing).
//
// What this design does about it (K2's, csrc/megakernel_armijo.cu, whose
// device code it shares through megakernel_common.cuh):
//   * 3 grid barriers per iteration, whatever k: (a) publish D, (b) the
//     line-search partials (2 p1, p2, the 9 Gram entries of
//     [lam, v, q1, q2] and the rp x lrc low-rank contractions), (c) the
//     gradient partials, which also carry every dot of the next direction.
//     After (c) thread 0 of every block solves the k x k triangular
//     systems in the same fixed order, after (b) every thread solves the
//     same quartic from the same totals, so every scalar (alpha, the
//     stagnation flag, the loop exit) is bitwise identical in every block.
//     No atomics: a block that decided differently would wait at the next
//     barrier forever;
//   * shared memory for the launch: C's column slab where it fits (float32
//     up to n_pad 2048, float64 up to 896), the ring's slab of s and y
//     where it also fits, else the ring stays in the caller's arrays and
//     is read from L2 (float64 with many slots at a wide rank), and always
//     the slab arrays (Rt, CRt, CDt, D and G, current and next);
//   * D goes from L2 straight into registers, eight 64-column steps per
//     batch, with all loads issued before the first FMA; each thread keeps
//     a 4 x 8 register tile and each warp sums its tile in 31 shuffles;
//   * block partials are stored slot-major, so the 32 lanes that sum one
//     slot read consecutive addresses;
//   * one warp per low-rank term and product forms the quartic's low-rank
//     coefficients;
//   * plain FP32 (FP64) FMAs, no tensor cores, so no dot is ever TF32 (the
//     JAX package found lower-precision Gram and low-rank dots trip the
//     stagnation test early).
//
// Data written by one block and read by another inside the launch (the
// partials, D) is written with __stcg and read with __ldcg, which bypass
// the non-coherent L1. The caller's s and y rings are updated in place.
//
// Timing build (-DK1_TIMING, chip_smoke.py phase 5): thread 0 of block 0
// adds the %globaltimer time between consecutive stamps to its phase's sum
// and counts the grid barriers; at exit it writes the sums (ns), the
// barrier count and the entry barriers to tbuf (int64). k1_phases() names
// the phases. Without the macro the stamps compile to nothing.

#include "megakernel_common.cuh"

namespace {

constexpr int N_LS = 2 + 9;      // line-search slots: 2 p1, p2, the Gram of 4

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
  void *tbuf;     // timing builds: per-phase ns, barriers (int64)
  void *stream;
  // filled in by k1_plan
  int S, nblk, smem_bytes, sms, blocks_per_sm, c_resident, ring_resident;
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
  int n, rp, k, use_hist, n_lr, n_lc, lrc, S, nblk, npart, c_res, cp, ring_res;
  int lr_off[MAX_LR + 1];
  int lr_cons[MAX_LR];
  T gscale, alpha_max;
  const T *scal, *C, *Rt_in, *lam, *w, *b;
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
// k1_smem_bytes mirrors it)
size_t smem_elems(int n, int rp, int k, int lrc, int S, int c_res,
                  int ring_res) {
  return (size_t)(c_res ? c_rows(S) * n : 0) +
         (size_t)(6 + (ring_res ? 2 * k : 0)) * rp * MAX_S + 6 * MAX_S +
         8 * 32 + npart_for(rp, k, lrc) + rp * lrc + 2 * MAX_S * MAX_LRC + k +
         2 * k * k + 2 * k + 1 + 2 * MAX_LR;
}

// the timing build's phases, in tbuf order
constexpr int K1_NPH = 11;
const char* const K1_PHASE_NAMES =
    "direction,d_barrier,dc,linesearch,ls_barrier,ls_totals,quartic,"
    "commit_gradient,push_dots,grad_barrier,grad_totals";
enum {
  PH_DIR, PH_D_BAR, PH_DC, PH_LS, PH_LS_BAR, PH_LS_TOT, PH_QUARTIC, PH_GRAD,
  PH_PUSH, PH_GRAD_BAR, PH_GRAD_TOT
};

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

// ---- the kernel -----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 1) k1_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, blk = blockIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int n = P.n, rp = P.rp, k = P.k, lrc = P.lrc, np = P.npart;
  const int c0 = blk * P.S;
  const int ns = min(P.S, n - c0);               // >= 1 by construction
  const int nel = rp * MAX_S;                    // slab array entries
  const int nblk = P.nblk;
  TIMER_DECL(K1_NPH);

  // shared-memory carve-up (smem_elems); slab arrays are (rp, MAX_S)
  T* Cs = sm;                                    // cp x n C slab, if resident
  T* Rt_s = Cs + (P.c_res ? (size_t)P.cp * n : 0);
  T* CRt_s = Rt_s + nel;
  T* CDt_s = CRt_s + nel;
  T* d_s = CDt_s + nel;
  T* g_s = d_s + nel;                            // 2 x (rp, MAX_S)
  T* sr_s = g_s + 2 * nel;                       // k x (rp, MAX_S) ring, if resident
  T* yr_s = sr_s + (P.ring_res ? (size_t)k * nel : 0);
  T* lam_s = yr_s + (P.ring_res ? (size_t)k * nel : 0);
  T* w_s = lam_s + MAX_S;
  T* b_s = w_s + MAX_S;
  T* vio_s = b_s + MAX_S;
  T* q1_s = vio_s + MAX_S;                       // 2 w sum_r R.D per column
  T* q2_s = q1_s + MAX_S;                        // w sum_r D.D per column
  T* red = q2_s + MAX_S;                         // 8 x 32 product tiles
  T* tot = red + 8 * 32;                         // npart
  T* Q = tot + np;                               // rp x lrc (identical in all blocks)
  T* Bs = Q + rp * lrc;                          // S x lrc slab of B
  T* Bdts = Bs + MAX_S * MAX_LRC;                // lrc x S slab of Bdt
  T* rho = Bdts + MAX_LRC * MAX_S;               // k
  T* STY = rho + k;                              // k x k, slot order
  T* YTY = STY + k * k;
  T* wv = YTY + k * k;                           // 2k compact coefficients
  T* hist_s = wv + 2 * k;                        // 1: the compact direction
  T* plr = hist_s + 1;                           // 2 x MAX_LR low-rank products

  // the ring's slot i as a slab: shared memory, or the caller's array
  auto sr = [&](int i) -> Slab<T> {
    return P.ring_res ? Slab<T>{sr_s + (size_t)i * nel, MAX_S}
                      : Slab<T>{P.s_ring + (size_t)i * rp * n + c0, n};
  };
  auto yr = [&](int i) -> Slab<T> {
    return P.ring_res ? Slab<T>{yr_s + (size_t)i * nel, MAX_S}
                      : Slab<T>{P.y_ring + (size_t)i * rp * n + c0, n};
  };

  const T eps = Eps<T>::v();
  const T sigma = P.scal[0];
  const T cur_gtol = P.scal[1];
  const T stag_tol = P.scal[2];
  const int max_steps = (int)P.scal[3];
  int head = (int)P.scal[4];
  const T* lam_lc = P.scal + 5 + k;
  const T* b_lc = lam_lc + P.n_lc;
  const T half = T(0.5), two = T(2);

  // ---- entry: slab state, ring, C slab, C.R, Q = R.B ---------------------
  for (int e = tid; e < 6 * nel + 6 * MAX_S + (P.ring_res ? 2 * k * nel : 0);
       e += NT)
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
      if (P.ring_res)
        for (int i = 0; i < k; ++i) {
          sr_s[i * nel + e] = P.s_ring[(size_t)i * rp * n + g];
          yr_s[i * nel + e] = P.y_ring[(size_t)i * rp * n + g];
        }
    }
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
  __syncthreads();
  cd_product(n, rp, P.C, P.c_res, P.Rt_in, T(1), c0, ns, Cs, red, CRt_s);

  int ph = 0;  // partial phases passed: selects the partial buffer
  auto slot = [&](int p) -> T* {
    return P.part + ((size_t)(ph & 1) * np + p) * nblk + blk;
  };
  // the totals of the partial phase just passed (npu slots) into tot
  auto totals = [&](int npu) {
    grid_totals(P.part + (size_t)(ph & 1) * np * nblk, nblk, npu, tot);
    ++ph;
  };

  // per-column violation and the (lam, vio) dots
  {
    T o = warp_slab_dot<T>(Rt_s, CRt_s, nel, ns);
    if (wid == 0 && lane == 0) __stcg(slot(0), o);
    if (tid == 32) {
      T lv = 0, vv = 0;
      for (int j = 0; j < ns; ++j) {
        T s = 0;
        for (int r = 0; r < rp; ++r) s += Rt_s[r * MAX_S + j] * Rt_s[r * MAX_S + j];
        T v = w_s[j] * s - b_s[j];
        vio_s[j] = v;
        lv += lam_s[j] * v;
        vv += v * v;
      }
      __stcg(slot(1), lv);
      __stcg(slot(2), vv);
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

  // gradient of the slab into Gdst (a slab array): 2 (CRt + (w.y) Rt) +
  // low-rank, y = -(lam - sigma v)
  int cur = 0;
  auto gradient = [&](T* Gdst) {
    for (int e = tid; e < nel; e += NT) {
      const int r = e >> 4, j = e & (MAX_S - 1);
      if (j >= ns) continue;
      T y_row = -(lam_s[j] - sigma * vio_s[j]);
      T g = two * (CRt_s[e] + (w_s[j] * y_row) * Rt_s[e]);
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
  for (int v = wid; v < 1 + 2 * k + 2 * k * k; v += NW) {
    const DotPair<Slab<T>> ab =
        entry_operands(v, k, Slab<T>{g_s, MAX_S}, sr, yr);
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
      bool hist = false;
      if (P.use_hist) {
        compact_w_any(k, head, rho, STY, YTY, pvec, wv);
        T s = gsq;
        for (int i = 0; i < 2 * k; ++i) s = s + wv[i] * pvec[i];
        const T descent = -s;
        hist = !((descent != descent) || descent >= T(0));
      }
      hist_s[0] = hist ? T(1) : T(0);
    }
    __syncthreads();
    const bool hist = hist_s[0] != T(0);
    for (int e = tid; e < nel; e += NT) {
      const int r = e >> 4, j = e & (MAX_S - 1);
      if (j >= ns) continue;
      T h = Gc[e];
      if (hist) {
        T acc = 0;
        for (int i = 0; i < k; ++i) acc = acc + wv[i] * sr(i)[e];
        for (int i = 0; i < k; ++i) acc = acc + wv[k + i] * yr(i)[e];
        h = h + acc;
      }
      d_s[e] = -h;
      __stcg(P.dbuf + (size_t)r * n + c0 + j, -h);
    }
    STAMP(PH_DIR);
    GRID_SYNC();
    STAMP(PH_D_BAR);

    // ---- line-search products ---------------------------------------------
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
        q1_s[j] = two * w_s[j] * rd;
        q2_s[j] = w_s[j] * dd;
      }
      __syncthreads();
      if (tid == 64) {
        T g[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        for (int j = 0; j < ns; ++j) {
          const T l = lam_s[j], v = vio_s[j], q1 = q1_s[j], q2 = q2_s[j];
          g[0] += l * v;   g[1] += v * v;
          g[2] += l * q1;  g[3] += v * q1;
          g[4] += l * q2;  g[5] += v * q2;
          g[6] += q1 * q1; g[7] += q1 * q2; g[8] += q2 * q2;
        }
        for (int i = 0; i < 9; ++i) __stcg(slot(2 + i), g[i]);
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
    STAMP(PH_LS_TOT);

    // ---- quartic coefficients and the line search (every thread) --------
    T p1 = tot[0], p2 = tot[1];
    const T* Gm = tot + 2;  // lv, vv, lq1, vq1, lq2, vq2, q1q1, q1q2, q2q2
    const T* p1_lr = plr;
    const T* p2_lr = plr + MAX_LR;
    for (int t = 0; t < P.n_lr; ++t)
      if (P.lr_cons[t] < 0) {
        p1 = p1 + p1_lr[t];
        p2 = p2 + p2_lr[t];
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
    const T rel_delta = (L_val - L_new) /
                        fmax(T(1), fmax(fabs(L_new), fabs(L_val)));
    const bool stag_new = rel_delta < stag_tol;
    const bool push = P.use_hist && !stag_new;
    const int jn = (head + 1) % k;               // the pushed slot
    STAMP(PH_QUARTIC);

    // ---- algebraic commit ---------------------------------------------------
    for (int j = tid; j < ns; j += NT)
      vio_s[j] = vio_s[j] + alpha * (alpha * q2_s[j] + q1_s[j]);
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
    STAMP(PH_GRAD);
    if (push) {
      const Slab<T> s_new = sr(jn), y_new = yr(jn);
      for (int e = tid; e < nel; e += NT) {
        if ((e & (MAX_S - 1)) >= ns) continue;
        s_new[e] = alpha * d_s[e];
        y_new[e] = Gn[e] - Gc[e];
      }
      __syncthreads();
    }
    for (int v = wid; v < (push ? 1 + 5 * k : 1 + 2 * k); v += NW) {
      const DotPair<Slab<T>> ab =
          grad_operands(v, k, jn, Slab<T>{Gn, MAX_S}, sr, yr);
      const T s = warp_slab_dot<T>(ab.a, ab.b, nel, ns);
      if (lane == 0) __stcg(slot(v), s);
    }
    STAMP(PH_PUSH);
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
    if (P.ring_res)
      for (int i = 0; i < k; ++i) {
        P.s_ring[(size_t)i * rp * n + g] = sr_s[i * nel + e];
        P.y_ring[(size_t)i * rp * n + g] = yr_s[i * nel + e];
      }
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
    const int n_vlr = P.n_lc > 1 ? P.n_lc : 1;
    for (int i = 0; i < n_vlr; ++i) o[7 + k + i] = i < P.n_lc ? vio_lr[i] : T(0);
    // the Grams after the launch, slot order
    T* og = o + 7 + k + n_vlr;
    for (int x = 0; x < k * k; ++x) {
      og[x] = STY[x];
      og[k * k + x] = YTY[x];
    }
  }
  TIMER_WRITE(P.tbuf, K1_NPH);
}

template <typename T>
int plan(K1Args* a) {
  int S = 0, nblk = 0, sms = 0;
  int rc = grid_plan(a->device, a->n_pad, &S, &nblk, &sms);
  if (rc != 0) return rc;
  // C's slab and the ring's where both fit, else C's, else the ring's
  const int order[4][2] = {{1, 1}, {1, 0}, {0, 1}, {0, 0}};
  int c_res = 0, ring_res = 0;
  size_t smem_sz = 0;
  for (int i = 0; i < 4; ++i) {
    smem_sz = smem_elems(a->n_pad, a->rp, a->k, a->lrc, S, order[i][0],
                         order[i][1]) * sizeof(T);
    c_res = order[i][0];
    ring_res = order[i][1];
    if (smem_sz <= (size_t)SMEM_MAX) break;
  }
  int per_sm = 0;
  rc = smem_setup(k1_kernel<T>, smem_sz, &per_sm);
  if (rc != 0) return rc;
  int np = npart_for(a->rp, a->k, a->lrc);
  a->S = S;
  a->nblk = nblk;
  a->smem_bytes = (int)smem_sz;
  a->sms = sms;
  a->blocks_per_sm = per_sm;
  a->c_resident = c_res;
  a->ring_resident = ring_res;
  a->work_elems = 1LL * a->rp * a->n_pad + 2LL * nblk * np;
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
  P.npart = npart_for(a->rp, a->k, a->lrc);
  P.c_res = a->c_resident;
  P.cp = c_rows(a->S);
  P.ring_res = a->ring_resident;
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
  P.tbuf = (long long*)a->tbuf;
  T* work = (T*)a->work;
  P.dbuf = work;
  P.part = work + 1LL * a->rp * a->n_pad;
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

// Fills S, nblk, smem_bytes, sms, blocks_per_sm, c_resident, ring_resident
// and work_elems of *a for its n_pad, rp, k, lrc and dtype. Returns a
// cudaError_t.
int k1_plan(K1Args* a) {
  return a->is_double ? plan<double>(a) : plan<float>(a);
}

// Launches K1 on a->stream; does not synchronise. Returns a cudaError_t
// (the launch's, then cudaGetLastError's).
int k1_launch(K1Args* a) {
  return a->is_double ? launch<double>(a) : launch<float>(a);
}

const char* k1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The timing build's phase names, comma-separated, in tbuf order.
const char* k1_phases() { return K1_PHASE_NAMES; }

}  // extern "C"
