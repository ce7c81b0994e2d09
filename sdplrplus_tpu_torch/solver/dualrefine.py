"""Host-side float64 dual-certificate machinery.

``build_S_operator`` rebuilds S(y) = Σ yᵢAᵢ + C entirely on the host in
float64 (scipy sparse + closures for low-rank terms) — a code path that
shares nothing with the solver's on-device f32 Lanczos, so its eigsh
bound independently certifies any artifact (the reference's
cross-check practice, reference: exps/exp_csdp/exp_csdp.jl:1-221).

``refine_dual`` then MAXIMIZES the dual value over y (any y certifies
by weak duality): damped Gauss-Newton LSQR steps that lift S's bottom
eigenband, with an accumulated eigenvector basis, per-step certified
line search, and trust control. It exists because the AL ascent
multiplier stalls on certificate-hard families (Lovász-θ at scale)
where the f32 inner loop cannot push S(λ̃)R → 0. The solver calls it as
an automatic post-solve polish on a near-miss (solver/outer.py);
exps/certify.py uses it for offline artifact certification. The
reference's analog is its ``eigval_highprecision`` escape
(reference: src/coreop.jl:351-374) — better eigensolve, same y; this
refines y itself, which is where the slack actually is."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def build_S_operator(C, As, y_head):
    """S(y) = Σ yᵢAᵢ + C as an f64 scipy LinearOperator (sparse parts
    pre-assembled into one CSR; low-rank parts applied as closures)."""
    from ..problem import SparseSym, SymLowRank, as_operand

    C = as_operand(C)
    n = C.n
    rows, cols, vals = [], [], []
    lowrank = []  # (weight, B, d)

    def add(op, w):
        if w == 0.0:
            return
        if isinstance(op, SparseSym):
            rows.append(op.rows)
            cols.append(op.cols)
            vals.append(w * op.vals)
        elif isinstance(op, SymLowRank):
            lowrank.append((w, op.B, op.d))
        else:  # pragma: no cover
            raise TypeError(type(op))

    add(C, 1.0)
    for i, Ai in enumerate(As):
        add(as_operand(Ai, n), float(y_head[i]))

    if rows:
        S_sp = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n), dtype=np.float64,
        )
    else:
        S_sp = sp.csr_matrix((n, n), dtype=np.float64)

    def matvec(x):
        out = S_sp @ x
        for w, B, d in lowrank:
            out = out + w * (B @ (d * (B.T @ x)))
        return out

    return spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64), n


def refine_dual(C, As, b, y0, tb, *, iters: int = 4, k_eig: int = 64,
                lsqr_iters: int = 200, damp: float = 1e-3,
                R=None, verbose: bool = True):
    """Host-side f64 dual-multiplier refinement.

    Any y is dual-feasible by weak duality, so the dual value
    d(y) = -⟨y,b⟩ + tb·min(λ_min(S(y)), 0) may be MAXIMIZED over y and
    every iterate certifies. The AL ascent multiplier is weak exactly
    when λ_min(S) is deep (e.g. Lovász-θ at n ≥ 5000, where the f32
    inner loop cannot push S(λ̃)R → 0 and σ stays at 2 so the explicit
    updates crawl — measured: -⟨y,b⟩ within 0.15% of θ while
    λ_min = -110). This routine fixes exactly that failure mode:

      repeat `iters` times:
        W  ← bottom k_eig eigenvectors of S(y)      (scipy eigsh, SA)
        δ* ← argmin_δ ‖(S(y) + Σδᵢ Aᵢ) W‖²_F + damp²‖δ‖²   (scipy lsqr)
        y  ← y + δ*,  record d(y)

    i.e. damped Gauss–Newton on the spectral objective: the LS step
    kills S's action on its own most-negative subspace — the directions
    that set λ_min — while the damping keeps -⟨y,b⟩ anchored. Returns
    (y_best, d_best, λ_min(y_best), history).

    No reference counterpart: the reference certifies only the AL
    iterate (src/coreop.jl:376-415). Equality constraints only (an
    inequality's y would need a sign projection; every entry-mode
    family is equality-only)."""
    from ..problem import SparseSym, SymLowRank, as_operand

    C_op = as_operand(C)
    n = C_op.n
    m = len(As)

    # global COO of all sparse constraints with constraint ids; lowrank
    # constraints handled as closures
    rows, cols, vals, cids = [], [], [], []
    lowrank = []  # (gid, B, d)
    for i, Ai in enumerate(As):
        op = as_operand(Ai, n)
        if isinstance(op, SparseSym):
            rows.append(op.rows)
            cols.append(op.cols)
            vals.append(op.vals)
            cids.append(np.full(len(op.rows), i, dtype=np.int64))
        elif isinstance(op, SymLowRank):
            lowrank.append((i, np.asarray(op.B, np.float64),
                            np.asarray(op.d, np.float64)))
        else:  # pragma: no cover
            raise TypeError(type(op))
    er = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    ec = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    ev = np.concatenate(vals).astype(np.float64) if vals else np.zeros(0)
    ei = np.concatenate(cids) if cids else np.zeros(0, np.int64)
    # symmetric expansion (SparseSym stores each unordered pair once)
    off = er != ec
    fr = np.concatenate([er, ec[off]])
    fc = np.concatenate([ec, er[off]])
    fv = np.concatenate([ev, ev[off]])
    fi = np.concatenate([ei, ei[off]])
    # static CSR skeleton (duplicate (i,j) across constraints collapse
    # into one slot) + slot-map P: M(y).data = P @ y, so both LSQR
    # operator directions are one sparse matmul each
    M0 = sp.csr_matrix((fv, (fr, fc)), shape=(n, n))
    M0.sum_duplicates()
    starts = M0.indptr[fr]
    ends = M0.indptr[fr + 1]
    # slot of (fr_k, fc_k): binary search inside its CSR row
    slot = starts + np.array([
        np.searchsorted(M0.indices[s:e], c)
        for s, e, c in zip(starts, ends, fc)
    ], dtype=np.int64)
    P_map = sp.csr_matrix((fv, (slot, fi)), shape=(M0.nnz, m))
    row_of_slot = np.repeat(np.arange(n), np.diff(M0.indptr))
    col_of_slot = M0.indices.astype(np.int64)

    # only b_i = 0 multipliers are free: moving a b_i != 0 multiplier
    # trades ≥1:1 against the -⟨y,b⟩ term (a cost the LS objective
    # cannot see — unfrozen, the LS inflates the trace multiplier to
    # fake λ_min progress); with them frozen the dual improves exactly
    # when λ_min does
    free = np.nonzero(np.asarray(b, np.float64) == 0.0)[0]
    P_free = P_map[:, free].tocsr()
    pos_in_free = {int(g): k for k, g in enumerate(free)}
    lr_free = [(pos_in_free[gid], B, d) for (gid, B, d) in lowrank
               if int(gid) in pos_in_free]

    def S_of(y):
        op, _ = build_S_operator(C, As, y)
        return op

    def lam_min_of(y):
        w = spla.eigsh(S_of(y), k=1, which="SA", tol=1e-7,
                       maxiter=max(10000, 100 * int(np.sqrt(n))),
                       ncv=min(n - 1, 96), return_eigenvectors=False)
        return float(w[0])

    def dval(y, lam_min):
        return float(-y @ b) + tb * min(lam_min, 0.0)

    y = np.asarray(y0, np.float64).copy()
    lam0 = lam_min_of(y)
    best = (y.copy(), dval(y, lam0), lam0)
    hist = [{"iter": 0, "lam_min": lam0, "dual": best[1]}]
    if verbose:
        print(f"refine 0: lam_min {lam0:.4f} dual {best[1]:.4f}",
              flush=True)

    W_acc = None  # accumulated (bundle) basis: without it each LS step
    #               un-fixes directions fixed by earlier passes and the
    #               iteration plateaus (measured on θ SYN5K)
    max_basis = 512
    lift = 0.5   # band-top overshoot factor, shrunk on failed steps
    fails = 0

    for it in range(1, iters + 1):
        k = min(k_eig, n - 2)
        wv, W = spla.eigsh(S_of(y), k=k, which="SA", tol=1e-6,
                           maxiter=max(10000, 100 * int(np.sqrt(n))),
                           ncv=min(n - 1, max(2 * k + 1, 96)))
        W_acc = W if W_acc is None else np.concatenate(
            [W_acc[:, -(max_basis - W.shape[1]):], W], axis=1)
        W_acc = np.linalg.qr(W_acc)[0]
        W = W_acc
        K = W.shape[1]

        def A_op(delta_f):
            # (Σ δᵢ Aᵢ) W over the free multipliers, flattened
            Md = sp.csr_matrix((P_free @ delta_f, M0.indices, M0.indptr),
                               shape=(n, n))
            out = Md @ W
            for k_f, B, d in lr_free:
                out = out + delta_f[k_f] * (B @ (d[:, None] * (B.T @ W)))
            return out.ravel()

        def At_op(res_flat):
            res = res_flat.reshape(n, K)
            s_p = np.einsum("pk,pk->p", W[col_of_slot], res[row_of_slot])
            g = np.asarray(P_free.T @ s_p)
            for k_f, B, d in lr_free:
                g[k_f] += float(np.sum((B @ (d[:, None] * (B.T @ W)))
                                       * res))
            return g

        # residual target: lift each basis column's Rayleigh quotient to
        # the TOP of the current bottom band (τ = max bottom-k Ritz
        # value), not to zero — ‖S·W‖ → 0 would push eigenvalues ~500
        # past the optimum (max_Y λ_min sits at -θ, far below 0 in the
        # C+Y frame) and burns the multipliers fighting an impossible
        # target (measured: plateau at dual ≈ -572 vs optimum -500)
        SW = np.asarray(S_of(y).matmat(W))
        ray = np.einsum("nk,nk->k", W, SW)
        # overshoot the band top by half the band width: the LS is
        # damped and line-searched, so an ambitious target just takes a
        # bigger certified-improving step per pass
        t_lift = float(np.max(wv)) + lift * float(np.max(wv) - np.min(wv))
        tau = np.maximum(ray, t_lift)
        rhs = -(SW - W * tau[None, :]).ravel()
        lin = spla.LinearOperator((n * K, len(free)), matvec=A_op,
                                  rmatvec=At_op, dtype=np.float64)
        delta_f = spla.lsqr(lin, rhs, damp=damp * np.linalg.norm(rhs),
                            iter_lim=lsqr_iters)[0]
        # step line search on the TRUE dual (each candidate certifies
        # on its own, so greedy-accept the first improvement)
        accepted = False
        for t in (1.0, 0.5, 0.25):
            y_t = y.copy()
            y_t[free] += t * delta_f
            lam = lam_min_of(y_t)
            d = dval(y_t, lam)
            if d > best[1]:
                y, accepted = y_t, True
                break
        hist.append({"iter": it, "lam_min": lam, "dual": d,
                     "step": t, "basis": K, "accepted": accepted})
        if verbose:
            print(f"refine {it}: lam_min {lam:.4f} dual {d:.4f} "
                  f"(step {t}, basis {K}, "
                  f"{'ok' if accepted else 'reverted'})", flush=True)
        if accepted:
            best = (y.copy(), d, lam)
            fails = 0
        else:
            # no candidate beat the incumbent: revert to the best y,
            # aim lower and regularize harder — walking on from a
            # worse iterate just drags the multiplier away (measured:
            # SYN2K dual -210.9 -> -288.7 over 11 'exploring' steps)
            y = best[0].copy()
            lift *= 0.3
            damp *= 3.0
            fails += 1
            if fails >= 3:
                break
    return best[0], best[1], best[2], hist


