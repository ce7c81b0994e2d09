"""One rank of the port's sharded-solve checks on the CPU (gloo).

Run as ``python tests/torch_spmd_cases.py --rank R --world N --rdv PATH
--out OUT --cases a,b,...``, one process per rank; ``launch_ranks``
starts them (tests/test_torch_parallel.py, tests/test_torch_multihost.py,
tests/test_torch_cuda.py). Each case runs the port's sharded code on
numpy inputs made from fixed seeds and rank 0 writes every case's full
(gathered) outputs to OUT as JSON; the tests hold them against the
port's single-device run and the JAX package's shard_map in the pytest
process. This module imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sdplrplus_tpu_torch import SDPProblem, compile_problem  # noqa: E402
from sdplrplus_tpu_torch.models import (  # noqa: E402
    lovasz_theta, make_random_graph, maxcut, minimum_bisection,
    synthetic_local_graph,
)
from sdplrplus_tpu_torch.ops.device import to_device  # noqa: E402

F64 = torch.float64
GENS = {"maxcut": maxcut, "minbisection": minimum_bisection}
INPUTS = {}   # arrays the launching test passed (--inputs), by name
OUT_DIR = None   # the launch's directory (where --out lies)


# ---- the cases' inputs (the tests build the same) ---------------------------

def inner_setup(gen: str):
    """test_shardmap.py:25-49: a 48-node graph, ELL width 64, r = 3."""
    A = make_random_graph(48, 0.5, seed=7)
    C, As, b = GENS[gen](A)[:3]
    prob = SDPProblem(C, As, np.asarray(b, float), None)
    cp = compile_problem(prob, ell_width=64)
    rng = np.random.default_rng(0)
    R0 = np.zeros((cp.n_pad, 3))
    R0[: prob.n] = rng.uniform(-1, 1, size=(prob.n, 3))
    return prob, cp, R0


def major_setup(dense: bool):
    """test_shardmap.py:72-100."""
    A = make_random_graph(48, 0.5, seed=3)
    C, As, b = maxcut(A)[:3]
    prob = SDPProblem(C, As, np.asarray(b, float), None)
    cp = compile_problem(prob, ell_width=64, dense=dense)
    rng = np.random.default_rng(1)
    R0 = np.zeros((cp.n_pad, 3))
    R0[: prob.n] = rng.uniform(-1, 1, size=(prob.n, 3))
    return prob, cp, R0


MAJOR_ARGS = dict(budget=120, major_budget=50, base_iter=0,
                  stag_tol=-math.inf, ptol_final=1e-3, gtol_final=0.0,
                  objtol=1e-3, sigmafac=2.0, trace_bound=48.0,
                  rankupd_tol=4)
ENTRY_ARGS = dict(MAJOR_ARGS, budget=100, major_budget=40, objtol=1e-2,
                  trace_bound=1.0)


def entry_setup(nd: int):
    """test_shardmap.py:131-150: Lovász θ in entry mode."""
    A = make_random_graph(40, 0.3, seed=11)
    C, As, b = lovasz_theta(A)
    prob = SDPProblem(C, As, np.asarray(b, float), None)
    cp = compile_problem(prob, entry=True, n_shards=nd)
    rng = np.random.default_rng(2)
    R0 = np.zeros((cp.n_pad, 3))
    R0[: prob.n] = rng.uniform(-1, 1, size=(prob.n, 3))
    return prob, cp, R0


def halo_setup(nd: int, dense=None):
    """test_halo.py:42-47: a ring-local graph where the halo is small."""
    A = synthetic_local_graph(512, 6, 16, seed=9)
    C, As, b = maxcut(A)[:3]
    prob = SDPProblem(C, list(As), np.asarray(b, float), None)
    pad = int(np.lcm(128, nd))
    cp = compile_problem(prob, n_shards=nd, row_pad=pad, nnz_pad=pad,
                         dense=dense)
    return prob, cp


def solve_setup():
    """test_halo.py:114-127: solve(devices=4) on a locality graph."""
    A = synthetic_local_graph(384, 6, 12, seed=4)
    C, As, b = maxcut(A)[:3]
    prob = SDPProblem(C, list(As), np.asarray(b, float), None)
    cfg = dict(ptol=1e-2, objtol=1e-2, printlevel=0, dtype="float32",
               prior_trace_bound=384.0, maxtime=600.0, device="cpu")
    return prob, cfg


def fg_state(dp, R0, lam, sigma):
    from sdplrplus_tpu_torch.solver.al import al_value_grad

    return al_value_grad(dp, torch.tensor(R0, device=dp.device), lam, sigma,
                         gtol_relative=True, ptol_relative=True)


def major_carry0(dp, R0, k: int):
    from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
    from sdplrplus_tpu_torch.solver.major import init_major_carry

    gen = torch.Generator().manual_seed(0)
    return init_major_carry(
        dp, torch.tensor(R0), torch.zeros(dp.m, dtype=F64), 2.0,
        2.0 ** -0.1, 0.5, gen, lbfgs_init(k, dp.n_pad, R0.shape[1], F64), 4,
        gtol_relative=True, ptol_relative=True)


def _l(x):
    return np.asarray(x.detach().cpu(), dtype=np.float64).tolist()


# ---- the cases --------------------------------------------------------------

def case_inner(mesh, gen: str):
    from sdplrplus_tpu_torch.parallel.comm import local_rows, n_loc
    from sdplrplus_tpu_torch.parallel.shardmap import (
        gather_inner, make_shardmap_inner, shardmap_problem)
    from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init

    prob, cp, R0 = inner_setup(gen)
    dev = mesh.device
    dp1 = to_device(cp, F64, dev)
    lam = torch.zeros(prob.m, dtype=F64, device=dev)
    L, vio, G, y, gn, _ = fg_state(dp1, R0, lam, 2.0)
    dpl = shardmap_problem(cp, F64, mesh)
    run = make_shardmap_inner(mesh, dpl, k=4, use_armijo=False)
    c, vn = run(dpl, local_rows(dpl, torch.tensor(R0, device=dev)),
                local_rows(dpl, G), y, vio, L, gn,
                lbfgs_init(4, n_loc(dpl), 3, F64, dev), lam, 2.0, 0.0,
                -math.inf, 12)
    c = gather_inner(c, mesh)
    return dict(R=_l(c.R), L=float(c.L_val), grad_norm=float(c.grad_norm),
                vio_norm=float(vn), steps=int(c.steps))


def case_ops(mesh, gen: str):
    """test_sharded.py:44-66: 𝒜(RRᵀ), 𝒜((RVᵀ+VRᵀ)/2), S·R on the diagonal
    and the general form, G = 2·S·R, on the all-gather layout."""
    from sdplrplus_tpu_torch.ops.adjoint import (
        apply_S, apply_S_general, gradient)
    from sdplrplus_tpu_torch.ops.forward import A_uu, A_uv
    from sdplrplus_tpu_torch.ops.lanczos import lanczos_v0
    from sdplrplus_tpu_torch.parallel.comm import all_gather_rows
    from sdplrplus_tpu_torch.parallel.spmd import (
        replicate, shard_factor, shard_problem)

    prob, cp, R, V, y = ops_inputs(gen, mesh.size)
    dpl = shard_problem(cp, F64, mesh)
    Rl, Vl = shard_factor(torch.tensor(R), mesh), shard_factor(
        torch.tensor(V), mesh)
    yt = replicate(torch.tensor(y), mesh)
    lam = replicate(torch.tensor(-y[:prob.m]), mesh)
    full = lambda X: all_gather_rows(X, mesh)
    return dict(
        A_uu=_l(A_uu(dpl, Rl)), A_uv=_l(A_uv(dpl, Rl, Vl)),
        S=_l(full(apply_S(dpl, yt, Rl))),
        S_general=_l(full(apply_S_general(dpl, yt, Rl))),
        G=_l(full(gradient(dpl, Rl, lam, 2.0, yt * 0.01)[0])),
        v0=_l(full(lanczos_v0(dpl, torch.Generator().manual_seed(0), F64))))


def ops_inputs(gen: str, nd: int):
    A = make_random_graph(64, 0.6, seed=0)
    C, As, b = GENS[gen](A)[:3]
    prob = SDPProblem(C, As, np.asarray(b, float), None)
    cp = compile_problem(prob, n_shards=nd, dense=False)
    rng = np.random.default_rng(0)
    R = np.zeros((cp.n_pad, 4))
    R[: prob.n] = rng.uniform(-1, 1, size=(prob.n, 4))
    V = np.zeros_like(R)
    V[: prob.n] = rng.normal(size=(prob.n, 4))
    y = np.concatenate([rng.normal(size=prob.m), [1.0]])
    return prob, cp, R, V, y


def _major_out(c, vn):
    return dict(steps=int(c.ic.steps), majoriters=int(c.majoriters),
                feas_count=int(c.feas_count), R=_l(c.ic.R), lam=_l(c.lam),
                vio_raw=_l(c.ic.vio_raw), max_dual=float(c.max_dual),
                vio_norm=float(vn))


def case_major(mesh, dense: bool):
    """The fused state machine from MAJOR_ARGS; the Lanczos bound starts
    from the launching test's ``v0_dense`` / ``v0_sparse`` when given
    (the JAX package's start vector), else from the carry's generator."""
    from sdplrplus_tpu_torch.parallel.shardmap import (
        gather_carry, make_shardmap_major, shard_carry, shardmap_problem)

    prob, cp, R0 = major_setup(dense)
    dp1 = to_device(cp, F64)
    carry0 = major_carry0(dp1, R0, 4)
    dpl = shardmap_problem(cp, F64, mesh)
    run = make_shardmap_major(mesh, dpl, k=4, use_armijo=False, q_max=64)
    v0 = INPUTS.get("v0_dense" if dense else "v0_sparse")
    kw = {} if v0 is None else dict(lanczos_v0=torch.tensor(v0))
    c, vn = run(dpl, shard_carry(carry0, dpl), *MAJOR_ARGS.values(), **kw)
    return _major_out(gather_carry(c, mesh), vn)


def case_entry(mesh):
    from sdplrplus_tpu_torch.parallel.shardmap import (
        gather_carry, make_shardmap_major, shard_carry, shardmap_problem)

    prob, cp, R0 = entry_setup(mesh.size)
    dp1 = to_device(cp, F64)
    carry0 = major_carry0(dp1, R0, 4)
    dpl = shardmap_problem(cp, F64, mesh)
    assert dpl.ew_c2.shape[0] == cp.n_pad // mesh.size   # rows sharded
    run = make_shardmap_major(mesh, dpl, k=4, use_armijo=False, q_max=64)
    c, vn = run(dpl, shard_carry(carry0, dpl), *ENTRY_ARGS.values())
    return _major_out(gather_carry(c, mesh), vn)


def halo_inputs(cp, seed=1):
    rng = np.random.default_rng(seed)
    lam = rng.normal(size=cp.m) * 0.1
    y = np.concatenate([-lam, [1.0]])
    X = rng.normal(size=(cp.n_pad, 5))
    return y, X


def case_halo(mesh):
    """test_halo.py:82-111: S·X (diagonal form through spmm_C, and the
    general form) with the row support all-gathered and as a halo."""
    from sdplrplus_tpu_torch.ops.adjoint import apply_S, apply_S_general
    from sdplrplus_tpu_torch.parallel.comm import all_gather_rows
    from sdplrplus_tpu_torch.parallel.shardmap import shardmap_problem
    from sdplrplus_tpu_torch.parallel.spmd import shard_factor

    prob, cp = halo_setup(mesh.size, dense=False)
    y, X = halo_inputs(cp)
    out = {}
    for halo in (False, True):
        dpl = shardmap_problem(cp, F64, mesh, halo=halo)
        assert (dpl.halo_send is not None) == halo
        Xl = shard_factor(torch.tensor(X), mesh)
        yt = torch.tensor(y)
        out[f"S_{halo}"] = _l(all_gather_rows(apply_S(dpl, yt, Xl), mesh))
        out[f"Sg_{halo}"] = _l(all_gather_rows(apply_S_general(dpl, yt, Xl),
                                               mesh))
    return out


def case_halo_inner(mesh):
    """25 steps of the fast-diagonal inner loop with the halo exchange
    (chip_smoke.py phase 18 (b) at test size)."""
    from sdplrplus_tpu_torch.ops import gather
    from sdplrplus_tpu_torch.parallel.comm import local_rows, n_loc
    from sdplrplus_tpu_torch.parallel.shardmap import (
        gather_inner, make_shardmap_inner, shardmap_problem)
    from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init

    prob, cp = halo_setup(mesh.size, dense=False)
    R0 = halo_R0(cp)
    dev = mesh.device
    dp1 = to_device(cp, F64, dev)
    lam = torch.zeros(prob.m, dtype=F64, device=dev)
    L, vio, G, y, gn, _ = fg_state(dp1, R0, lam, 2.0)
    dpl = shardmap_problem(cp, F64, mesh, halo=True)
    run = make_shardmap_inner(mesh, dpl, k=4, use_armijo=False)
    before = gather.ROWS.launches
    c, vn = run(dpl, local_rows(dpl, torch.tensor(R0, device=dev)),
                local_rows(dpl, G), y, vio, L, gn,
                lbfgs_init(4, n_loc(dpl), 4, F64, dev), lam, 2.0, 0.0,
                -math.inf, 25)
    launches = gather.ROWS.launches - before
    c = gather_inner(c, mesh)
    return dict(R=_l(c.R), L=float(c.L_val), grad_norm=float(c.grad_norm),
                steps=int(c.steps), halo=dpl.halo_send is not None,
                gather_rows=launches)


def halo_R0(cp):
    rng = np.random.default_rng(3)
    R0 = np.zeros((cp.n_pad, 4))
    R0[: cp.n] = rng.uniform(-1, 1, size=(cp.n, 4))
    return R0


def case_solve(mesh):
    """solve(devices=4) on the locality graph; a rank places no whole
    problem on its device (outer.to_device refuses here)."""
    from sdplrplus_tpu_torch import SolverConfig
    from sdplrplus_tpu_torch.solver import outer
    from sdplrplus_tpu_torch.solver.outer import solve

    def refuse(*a, **kw):
        raise AssertionError("the sharded solve placed the whole problem")

    outer.to_device = refuse
    prob, cfg = solve_setup()
    res = solve(prob, 6, SolverConfig(**cfg).copy_with(devices=mesh.size),
                mesh=mesh)
    return dict(obj=res["obj"], primal_vio=res["primal_vio"],
                devices=res["devices"], inner_engine=res["inner_engine"],
                R_rows=int(np.asarray(res["R"]).shape[0]))


def case_sdplr(mesh):
    """Every rank calls sdplr(devices=world size) under an initialized
    process group (the multi-process SPMD entry)."""
    from sdplrplus_tpu_torch import sdplr

    A = make_random_graph(40, 0.5, seed=5)
    C, As, b = maxcut(A)[:3]
    res = sdplr(C, As, b, 3, devices=mesh.size, device="cpu",
                dtype="float64", ptol=1e-4, objtol=1e-4, printlevel=0,
                prior_trace_bound=40.0)
    return dict(obj=res["obj"], iter=res["iter"], devices=res["devices"],
                inner_engine=res["inner_engine"], R=np.asarray(
                    res["R"]).tolist())


def paths_setup():
    """Solves through the sharded outer loop's host-side paths (the tests run
    each on one device too), float64:

      * ``theta``: Lovász θ of C₈₀² on the entry-mask engine, stopped at
        60 iterations: the final iterate's bound (no strict boundary was
        reached), the entry certificate from the gathered factor and
        wide weights, the DIMACS errors and a checkpoint;
      * ``double``: MaxCut on 90 nodes from rank 1 with rankupd_tol 1,
        warm rank
        doubling (the factor gathered, padded and re-sliced) to rank 4,
        to a certificate, with the DIMACS errors."""
    from sdplrplus_tpu_torch.models import synthetic_cycle_power

    base = dict(device="cpu", dtype="float64", printlevel=0,
                eval_DIMACS_errs=True)
    theta = (lovasz_theta(synthetic_cycle_power(80, 2)), 2, dict(
        base, ptol=1e-2, objtol=1e-2, prior_trace_bound=1.0, maxiter=60))
    double = (maxcut(make_random_graph(90, 0.2, seed=5))[:3], 1, dict(
        base, ptol=1e-3, objtol=1e-3, prior_trace_bound=90.0,
        rankupd_tol=1, rank_update_mode="warm"))
    return {"theta": theta, "double": double}


PATH_KEYS = ("obj", "obj_feasible", "max_dual_value", "rel_duality_gap",
             "primal_vio", "iter", "majoriter", "r", "dual_bounds_computed",
             "inner_engine", "devices")


def case_paths(mesh):
    from sdplrplus_tpu_torch import sdplr
    from sdplrplus_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    for name, ((C, As, b), r, kw) in paths_setup().items():
        ck = os.path.join(OUT_DIR, f"ck_{name}.npz")
        res = sdplr(C, As, b, r, devices=mesh.size, checkpoint_path=ck, **kw)
        row = {key: res[key] for key in PATH_KEYS}
        row.update(R=np.asarray(res["R"]).tolist(),
                   DIMACS_errs=np.asarray(res["DIMACS_errs"]).tolist())
        if mesh.rank == 0:
            state = load_checkpoint(ck)
            row.update(ck_R=np.asarray(state["R"]).tolist(),
                       ck_r=int(state["r"]))
        out[name] = row
    return out


CASES = {
    "inner_maxcut": lambda m: case_inner(m, "maxcut"),
    "inner_minbisection": lambda m: case_inner(m, "minbisection"),
    "ops_maxcut": lambda m: case_ops(m, "maxcut"),
    "ops_minbisection": lambda m: case_ops(m, "minbisection"),
    "major_sparse": lambda m: case_major(m, False),
    "major_dense": lambda m: case_major(m, True),
    "entry": case_entry,
    "halo": case_halo,
    "halo_inner": case_halo_inner,
    "solve": case_solve,
    "sdplr": case_sdplr,
    "paths": case_paths,
}


def launch_ranks(tmp_dir, nd, case_names, *, multihost=False,
                 timeout=240, device="cpu", inputs=None):
    """Run ``nd`` rank processes of tests/torch_spmd_cases.py and return
    rank 0's JSON. A rank that fails or outlives ``timeout`` fails the
    launch (the others are killed). ``device`` "cuda" puts every rank's
    tensors on the one card, its collectives staged through host memory
    (gloo). ``inputs``: numpy arrays by name, which the cases read from
    ``INPUTS``."""
    os.makedirs(tmp_dir, exist_ok=True)
    out = os.path.join(tmp_dir, "out.json")
    extra = []
    if inputs:
        path = os.path.join(tmp_dir, "inputs.npz")
        np.savez(path, **inputs)
        extra = ["--inputs", path]
    if multihost:
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        rdv = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
    else:
        rdv = os.path.join(tmp_dir, "rdv")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, script, "--rank", str(r), "--world", str(nd),
         "--rdv", rdv, "--out", out, "--cases", ",".join(case_names),
         "--device", device] + extra
        + (["--multihost"] if multihost else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nd)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    with open(out) as f:
        return json.load(f)


def main(argv=None):
    import torch.distributed as dist

    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rdv", required=True,
                   help="file:// path, or host:port with --multihost")
    p.add_argument("--multihost", action="store_true",
                   help="join through parallel.multihost.initialize")
    p.add_argument("--out", required=True)
    p.add_argument("--cases", required=True)
    p.add_argument("--device", default="cpu",
                   help="cpu, or cuda: every rank on card 0 over gloo")
    p.add_argument("--inputs", default=None,
                   help=".npz of arrays the cases read (INPUTS)")
    a = p.parse_args(argv)
    global OUT_DIR
    OUT_DIR = os.path.dirname(os.path.abspath(a.out))
    if a.inputs is not None:
        with np.load(a.inputs) as z:
            INPUTS.update({k: z[k] for k in z.files})
    torch.set_num_threads(1)
    if a.multihost:
        from sdplrplus_tpu_torch.parallel.multihost import (
            global_mesh, initialize, process_info)

        initialize(a.rdv, a.world, a.rank, backend="gloo", device="cpu")
        mesh = global_mesh()
        info = process_info()
    else:
        from sdplrplus_tpu_torch.parallel.spmd import make_mesh

        dist.init_process_group("gloo", init_method=f"file://{a.rdv}",
                                world_size=a.world, rank=a.rank)
        mesh = make_mesh(a.world, device=a.device)
        info = None
    try:
        out = {c: CASES[c](mesh) for c in a.cases.split(",")}
        if info is not None:
            out["process_info"] = info
        if mesh.rank == 0:
            with open(a.out, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
