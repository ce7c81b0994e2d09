"""K1's inner loop evaluated on the host in extended precision: a third
value to hold K1 and its plain version against.

``mega_chunk_ext`` runs ``ops/megakernel.mega_chunk_plain``'s algorithm
(the compact L-BFGS direction on the ring's Grams, the exact quartic line
search with its Newton polish, the algebraic commit, the gradient and
the ring push) in numpy ``longdouble`` (80-bit extended precision on
x86-64: a 64-bit significand, 2¹¹ times float64's) from the kernel's own
inputs (``mega_inputs``). Where K1 and its plain version part by more
than their tolerance, the one with the fault sits far from this value and
the other near it; when both sit within a few units of float64 rounding
of the computation, the difference is rounding.

Beside the values it keeps a running first-order bound of their float64
rounding: every quantity the loop carries (C·R, R·B, the violations) gets
an absolute scale, the sum of the absolute values it was made from, and
every commit X ← X + α·dX adds |α|·scale(dX). The gradient's scale is
then 2·(scale(C·R) + |w|·(|λ| + σ·scale(v))·|R| + Σ_t Y_t·scale(R·B_t)·
|d_t ⊙ B_tᵀ|) with Y_t = |λ_t| + σ·scale(v_t) (1 for an objective term):
each entry of a float64 evaluation of G lies within a small multiple of
eps times it. MinBisection's uncentred coupling 1ᵀX1 makes that scale
large: its violation is a large, cancelling sum, multiplied by σ and by
1ᵀR in every entry of G.

A check, not a solver path: nothing of the solver imports it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compile import compile_problem
from ..models import problems
from ..problem import SDPProblem
from ..solver.lbfgs import lbfgs_init
from . import megakernel as mk
from .device import to_device

LD = np.longdouble


def _ld(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), dtype=LD)


def _cubic_roots(a, b, c, d, eps):
    """ops/megakernel._cubic_roots in numpy scalars."""
    scale = max(abs(a), abs(b), abs(c), abs(d)) + eps
    is_cubic = abs(a) > eps * scale
    is_quad = abs(b) > eps * scale
    if not is_cubic:
        if not is_quad:
            return [-d / c if abs(c) > 0 else -d]
        # the kernel takes the quadratic's second root only
        disc_q = c * c - 4 * b * d
        return [(-c - np.sqrt(disc_q)) / (2 * b)] if disc_q >= 0 else []
    bb, cc, dd = b / a, c / a, d / a
    p = cc - bb * bb / 3
    q = 2 * bb * bb * bb / 27 - bb * cc / 3 + dd
    shift = -bb / 3
    disc = (q / 2) ** 2 + (p / 3) ** 3
    if disc > 0:
        sd = np.sqrt(disc)
        return [np.cbrt(-q / 2 + sd) + np.cbrt(-q / 2 - sd) + shift]
    pm = min(p, -eps)
    rr = np.sqrt(-pm / 3)
    phi = np.arccos(np.clip(3 * q / (2 * pm * rr), LD(-1), LD(1)))
    pi = np.arccos(LD(-1))
    return [2 * rr * np.cos((phi - 2 * pi * t) / 3) + shift for t in range(3)]


def _minimize_quartic(e, d1, c1, b1, a1, alpha_max, eps):
    """ops/megakernel.minimize_quartic_kernel in numpy scalars: the
    derivative cubic's real roots, one Newton polish each, clipped, against
    both endpoints (the first strictly smaller value wins)."""
    def fval(x):
        return e + x * (d1 + x * (c1 + x * (b1 + x * a1)))

    cands = []
    for x in _cubic_roots(4 * a1, 3 * b1, 2 * c1, d1, eps):
        fpp = 2 * c1 + x * (6 * b1 + x * 12 * a1)
        if abs(fpp) > eps:
            x = x - (d1 + x * (2 * c1 + x * (3 * b1 + x * 4 * a1))) / fpp
        cands.append(min(max(x, LD(0)), alpha_max))
    cands += [alpha_max, LD(0)]
    best = cands[0]
    for x in cands[1:]:
        if fval(x) < fval(best):
            best = x
    return best, fval(best)


def _tri_solve(T, rhs, upper: bool):
    """Solve T·x = rhs for a triangular (k, k) T by substitution."""
    k = T.shape[0]
    x = np.zeros(k, dtype=LD)
    order = range(k - 1, -1, -1) if upper else range(k)
    for i in order:
        js = range(i + 1, k) if upper else range(i)
        x[i] = (rhs[i] - sum((T[i, j] * x[j] for j in js), LD(0))) / T[i, i]
    return x


def _compact_w(k, head, rho, sty, yty, p):
    """ops/megakernel._compact_w_plain in numpy."""
    perm = np.array([(head + 1 + a) % k for a in range(k)])
    empty = rho[perm] == 0
    live = ~(empty[:, None] | empty[None, :])
    stp = np.where(live, sty[perm][:, perm], LD(0))
    ytp = np.where(live, yty[perm][:, perm], LD(0))
    Rp = np.triu(stp) + np.diag(empty.astype(LD))
    u = _tri_solve(Rp, p[perm], upper=True)
    v = np.diagonal(stp) * u + ytp @ u - p[k + perm]
    w1 = _tri_solve(Rp.T, v, upper=False)
    w = np.zeros(2 * k, dtype=LD)
    w[perm] = w1
    w[k + perm] = -u
    return w


def mega_chunk_ext(spec, scal, C, Rt_in, lam_row, w_row, b_row, s_ring,
                   y_ring, lr_B, lr_Bdt, lr_d) -> dict:
    """K1's loop from ``mega_inputs``' arguments, in longdouble on the
    host. Returns {"Rt", "G", "vio"} (longdouble, the kernel's layout),
    "alphas" (the steps taken) and "G_scale" (the rounding scale of G
    above). Leaves the rings unchanged."""
    k = spec.k
    eps = LD(np.finfo(np.float64).eps)   # the kernel's constants
    sc = _ld(scal)
    sigma, cur_gtol, stag_tol = sc[0], sc[1], sc[2]
    max_steps, head = int(sc[3]), int(sc[4])
    rho = sc[5:5 + k].copy()
    n_lc = len(spec.lr_cons)
    lam_lc = sc[5 + k:5 + k + n_lc]
    b_lc = sc[5 + k + n_lc:5 + k + 2 * n_lc]
    C, Rt = _ld(C), _ld(Rt_in)
    lam, w, b = _ld(lam_row), _ld(w_row), _ld(b_row)
    B, Bdt, d = _ld(lr_B), _ld(lr_Bdt), _ld(lr_d)
    S2 = _ld(s_ring).reshape(k, -1)
    Y2 = _ld(y_ring).reshape(k, -1)
    off = np.concatenate([[0], np.cumsum(spec.lr_sizes)]).astype(int)
    sl = [slice(off[t], off[t + 1]) for t in range(spec.n_lr)]
    cons = {t: i for i, t in enumerate(spec.lr_cons)}
    aC, aB, aBdt, ad = np.abs(C), np.abs(B), np.abs(Bdt), np.abs(d)

    def lr_tr(Qa, Qb, t, d=d):
        return np.sum(Qa[:, sl[t]] * Qb[:, sl[t]] * d[sl[t]])

    def state(Rt, CRt, Q):
        obj = np.sum(Rt * CRt) + sum(
            (lr_tr(Q, Q, t) for t in range(spec.n_lr) if spec.lr_is_obj[t]),
            LD(0))
        vio = w * np.sum(Rt * Rt, axis=0, keepdims=True) - b
        vio_lr = [lr_tr(Q, Q, t) - b_lc[i] for t, i in cons.items()]
        return obj, vio, vio_lr

    def al(obj, vio, vio_lr):
        L = obj - np.sum(lam * vio) + sigma / 2 * np.sum(vio * vio)
        for i in range(n_lc):
            L += -lam_lc[i] * vio_lr[i] + sigma / 2 * vio_lr[i] ** 2
        return L

    def y_lr(t, vio_lr):
        return LD(1) if spec.lr_is_obj[t] else \
            -(lam_lc[cons[t]] - sigma * vio_lr[cons[t]])

    def grad(Rt, CRt, Q, vio, vio_lr):
        G = 2 * (CRt + (w * -(lam - sigma * vio)) * Rt)
        for t in range(spec.n_lr):
            G = G + 2 * y_lr(t, vio_lr) * (Q[:, sl[t]] @ Bdt[sl[t]])
        return G

    CRt, Q = Rt @ C, Rt @ B
    obj, vio, vio_lr = state(Rt, CRt, Q)
    # the rounding scales of the carried quantities
    s_CRt, s_Q = np.abs(Rt) @ aC, np.abs(Rt) @ aB
    s_vio = np.abs(w) * np.sum(Rt * Rt, axis=0, keepdims=True) + np.abs(b)
    s_vlr = [lr_tr(s_Q, s_Q, t, ad) + abs(b_lc[i]) for t, i in cons.items()]
    L_val = al(obj, vio, vio_lr)
    G = grad(Rt, CRt, Q, vio, vio_lr)
    sty, yty = S2 @ Y2.T, Y2 @ Y2.T
    gscale = LD(spec.gscale)
    alphas = []
    steps, stag = 0, False
    while (np.sqrt(np.sum(G * G)) / gscale > cur_gtol and steps < max_steps
           and not stag):
        g = G.reshape(-1)
        D = -G
        if spec.use_hist:
            p = np.concatenate([S2 @ g, Y2 @ g])
            wc = _compact_w(k, head, rho, sty, yty, p)
            descent = -(np.sum(g * g) + wc @ p)
            if not (np.isnan(descent) or descent >= 0):
                D = -(g + np.concatenate([S2, Y2]).T @ wc).reshape(G.shape)
        CDt, Qd = D @ C, D @ B
        p1, p2 = 2 * np.sum(Rt * CDt), np.sum(D * CDt)
        q1 = 2 * w * np.sum(Rt * D, axis=0, keepdims=True)
        q2 = w * np.sum(D * D, axis=0, keepdims=True)
        p1_lr = [2 * lr_tr(Q, Qd, t) for t in range(spec.n_lr)]
        p2_lr = [lr_tr(Qd, Qd, t) for t in range(spec.n_lr)]
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                p1, p2 = p1 + p1_lr[t], p2 + p2_lr[t]
        e = obj - np.sum(lam * vio) + sigma / 2 * np.sum(vio * vio)
        d1 = p1 - np.sum(lam * q1) + sigma * np.sum(vio * q1)
        c1 = (p2 - np.sum(lam * q2) + sigma * np.sum(vio * q2)
              + sigma / 2 * np.sum(q1 * q1))
        b1 = sigma * np.sum(q1 * q2)
        a1 = sigma / 2 * np.sum(q2 * q2)
        for t, i in cons.items():
            lq1, lq2, lv = p1_lr[t], p2_lr[t], vio_lr[i]
            e += -lam_lc[i] * lv + sigma / 2 * lv * lv
            d1 += -lam_lc[i] * lq1 + sigma * lv * lq1
            c1 += -lam_lc[i] * lq2 + sigma * lv * lq2 + sigma / 2 * lq1 * lq1
            b1 += sigma * lq1 * lq2
            a1 += sigma / 2 * lq2 * lq2
        alpha, L_new = _minimize_quartic(e, d1, c1, b1, a1,
                                         LD(spec.alpha_max), eps)
        alphas.append(alpha)
        # the algebraic commit, and the scales it adds
        aD, a = np.abs(D), abs(alpha)
        s_Qd = aD @ aB
        s_vio = s_vio + a * np.abs(w) * (
            2 * np.sum(np.abs(Rt) * aD, axis=0, keepdims=True)
            + a * np.sum(D * D, axis=0, keepdims=True))
        s_vlr = [s_vlr[i] + a * (2 * lr_tr(s_Q, s_Qd, t, ad)
                                 + a * lr_tr(s_Qd, s_Qd, t, ad))
                 for t, i in cons.items()]
        s_CRt, s_Q = s_CRt + a * (aD @ aC), s_Q + a * s_Qd
        vio = vio + alpha * (alpha * q2 + q1)
        vio_lr = [vio_lr[i] + alpha * (alpha * p2_lr[t] + p1_lr[t])
                  for t, i in cons.items()]
        obj = obj + alpha * (alpha * p2 + p1)
        Rt, CRt, Q = Rt + alpha * D, CRt + alpha * CDt, Q + alpha * Qd
        G_new = grad(Rt, CRt, Q, vio, vio_lr)
        rel = (L_val - L_new) / max(LD(1), abs(L_new), abs(L_val))
        stag = bool(rel < stag_tol)
        if spec.use_hist and not stag:
            j = (head + 1) % k
            S2[j] = (alpha * D).reshape(-1)
            Y2[j] = (G_new - G).reshape(-1)
            sty[j, :], sty[:, j] = Y2 @ S2[j], S2 @ Y2[j]
            yty[j, :] = Y2 @ Y2[j]
            yty[:, j] = yty[j, :]
            rho[j] = 1 / sty[j, j]
            head = j
        G, L_val = G_new, L_new
        steps += 1

    G_scale = s_CRt + np.abs(w) * (np.abs(lam) + sigma * s_vio) * np.abs(Rt)
    for t in range(spec.n_lr):
        Y = LD(1) if spec.lr_is_obj[t] else \
            abs(lam_lc[cons[t]]) + sigma * s_vlr[cons[t]]
        G_scale = G_scale + Y * (s_Q[:, sl[t]] @ aBdt[sl[t]])
    return {"Rt": Rt, "G": G, "vio": vio, "alphas": alphas,
            "G_scale": 2 * G_scale}


def k1_case(device, family="minimum_bisection", steps=2, n=200, r=64, k=16,
            seed=0, dtype=None):
    """(spec, args, meta, data): K1's inputs for ``steps`` steps on a
    random graph (n, p = 0.5, ``seed``) of ``family`` with dense C, from
    R uniform(-1, 1), λ = 0.1·normal and σ = 2, an empty ring, the
    stagnation test off and gtol 1e-12, in float64 unless ``dtype`` says
    otherwise: the state of the card test that holds K1 against its plain
    version step by step (tests/test_torch_cuda.py), whose float64 case
    at r = 64, k = 16, MinBisection, step 2 differs most."""
    dtype = dtype or torch.float64
    A = problems.make_random_graph(n, 0.5, seed=seed)
    C, As, b = getattr(problems, family)(A)
    dp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                              None), dense=True),
                   dtype, device)
    meta, data = mk.prepare_mega_data(dp, k=k, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, r)
    rng = np.random.default_rng(seed + 1)
    R0 = np.zeros((dp.n_pad, r))
    R0[:n] = rng.uniform(-1, 1, (n, r))
    lam = 0.1 * rng.standard_normal(dp.m)
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    args = mk.mega_inputs(spec, r, data, t(R0),
                          lbfgs_init(k, dp.n_pad, r, dtype, device), t(lam),
                          t(2.0), 1e-12, float("-inf"), steps)
    return spec, args, meta, data


def rounding_report(ext: dict, outputs) -> dict:
    """Where one float64 evaluation of K1's loop (``outputs`` = (Rt, G,
    vio, oscal), from the kernel or its plain version) lies against the
    extended-precision one: max |ΔG|, max |ΔR|, max |Δvio|, and
    max |ΔG| / (eps·G_scale) over the live entries, the error in units of
    the gradient's float64 rounding scale (a few units: rounding; the
    worst-case bound of a length-n sum is about n/2 units)."""
    Rt, G, vio = (_ld(x) for x in outputs[:3])
    eps = float(np.finfo(np.float64).eps)
    dG = np.abs(G - ext["G"])
    live = ext["G_scale"] > 0
    return {
        "max_dG": float(dG.max()),
        "max_dR": float(np.abs(Rt - ext["Rt"]).max()),
        "max_dvio": float(np.abs(vio - ext["vio"]).max()),
        "dG_in_scale_units": float(
            (dG[live] / (eps * ext["G_scale"][live])).max()),
        "max_G": float(np.abs(ext["G"]).max()),
        "eps_G_scale": float(eps * ext["G_scale"].max()),
    }
