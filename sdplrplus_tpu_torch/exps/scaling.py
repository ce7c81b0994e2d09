"""Multi-device scaling of the sharded solve: the fused driver's time per
inner step and the SpMM's comms volume at 1, 2, 4 and 8 ranks, with the
row support all-gathered and exchanged as a halo.

Counterpart of the JAX package's ``exps/scaling.py``. The ranks are
processes of torch.distributed: gloo on the CPU (``--device cpu``, the
JAX package's virtual CPU mesh), or NCCL with one card per rank
(``--device cuda``) where the machine has the cards; a world size the
machine cannot hold gets no time (``per_step_s`` null, with the reason).
The time columns measure the host-side program (work division and the
collectives' overhead), not an interconnect; the comms columns are the
exact word counts each layout receives per rank per operator pass:

    all-gather:  (n_pad − n_loc) · r
    halo:        (nd − 1) · H · r

    python -m sdplrplus_tpu_torch.exps.scaling [--n 20000] [--deg 16]
        [--device cpu|cuda] [--no-time] [--out FILE]

Writes one JSON with a row per (graph kind, nd, layout).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from .common import OUTPUT, device_info, repo_commit


def _graphs(n: int, deg: int, window: int) -> dict:
    from ..models import synthetic_graph, synthetic_local_graph

    return {"random": synthetic_graph(n, deg),
            "local": synthetic_local_graph(n, deg, window)}


def _compile(A, nd: int):
    from ..compile import compile_problem
    from ..models import maxcut
    from ..parallel.shardmap import n_shards_pad
    from ..problem import SDPProblem

    C, As, b = maxcut(A)[:3]
    prob = SDPProblem(C, list(As), np.asarray(b, float), None)
    pad = n_shards_pad(nd)
    # the fast-diagonal engine (C sparse), whose SpMM the layouts feed
    return compile_problem(prob, n_shards=nd, row_pad=pad, nnz_pad=pad,
                           dense=False)


def comms_words(cp, nd: int, r: int, halo: bool) -> int:
    """Words one rank receives per operator pass."""
    if nd == 1:
        return 0
    if halo:
        return (nd - 1) * cp.halo_H * r
    return (cp.n_pad - cp.n_pad // nd) * r


def _carry0(dp, r: int, k: int):
    """The carry at a seeded factor; on a rank-local problem, this rank's
    rows of it."""
    from ..parallel.comm import local_rows, n_loc
    from ..solver.lbfgs import lbfgs_init
    from ..solver.major import init_major_carry

    rng = np.random.default_rng(0)
    R0 = np.zeros((dp.n_pad, r), np.float32)
    R0[: dp.n] = rng.uniform(-1, 1, (dp.n, r))
    return init_major_carry(
        dp, local_rows(dp, torch.tensor(R0, device=dp.device)),
        torch.zeros(dp.m, dtype=torch.float32, device=dp.device), 2.0,
        2.0 ** -0.1, 1e-6, torch.Generator().manual_seed(0),
        lbfgs_init(k, n_loc(dp), r, torch.float32, dp.device), 4,
        gtol_relative=True, ptol_relative=True)


def time_steps(cp, r: int, steps: int, device, mesh=None,
               halo: bool = False) -> tuple:
    """(seconds per inner step, steps) of one major_chunk call with a
    budget of ``steps`` (one major boundary), after a 2-step warm call;
    on the rank-local problem of ``mesh`` when given."""
    from ..ops.device import to_device
    from ..parallel.shardmap import make_shardmap_major, shardmap_problem
    from ..solver.major import major_chunk

    k = 4
    if mesh is None:
        dp = to_device(cp, torch.float32, device)
        chunk = functools.partial(major_chunk, **_KW)
    else:
        dp = shardmap_problem(cp, torch.float32, mesh, halo=halo)
        chunk = make_shardmap_major(mesh, dp, **_KW)
    run = lambda c, s: chunk(dp, c, *_chunk_args(s, cp.n))
    carry0 = _carry0(dp, r, k)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    run(carry0, 2)
    sync()
    t0 = time.perf_counter()
    out, _ = run(_carry0(dp, r, k), steps)
    sync()
    dt = time.perf_counter() - t0
    return dt / max(out.ic.steps, 1), int(out.ic.steps)


_KW = dict(k=4, use_armijo=False, gtol_relative=True, ptol_relative=True,
           objtol_relative=True, q_max=64, highprecision=False)


def _chunk_args(steps: int, n: int) -> tuple:
    # budget, major budget, base iter, stag_tol, ptol, gtol, objtol,
    # sigmafac, trace bound, rank-update countdown
    return (steps, 1, 0, -np.inf, 1e-6, 0.0, 1e-2, 2.0, float(n), 4)


def _rank_worker(rank: int, nd: int, backend: str, dev_type: str, tmp: str,
                 spec: dict):
    """One rank of a timed world: join, time, rank 0 writes the row."""
    import torch.distributed as dist

    from ..parallel.spmd import make_mesh

    device = (torch.device("cuda", rank) if dev_type == "cuda"
              else torch.device("cpu"))
    if dev_type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // nd))
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                            world_size=nd, rank=rank)
    try:
        mesh = make_mesh(nd, device=device)
        A = _graphs(spec["n"], spec["deg"], spec["window"])[spec["kind"]]
        cp = _compile(A, nd)
        per_step, steps = time_steps(cp, spec["r"], spec["steps"], device,
                                     mesh=mesh, halo=spec["halo"])
        if rank == 0:
            with open(os.path.join(tmp, "row.json"), "w") as f:
                json.dump([per_step, steps], f)
    finally:
        dist.destroy_process_group()


def time_world(nd: int, device: str, spec: dict) -> tuple:
    """(per_step_s, steps) of ``nd`` spawned ranks (NCCL on cards, gloo on
    the CPU)."""
    dev_type = torch.device(device).type
    backend = "nccl" if dev_type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="sdplr_scaling_")
    torch.multiprocessing.spawn(_rank_worker,
                                args=(nd, backend, dev_type, tmp, spec),
                                nprocs=nd, join=True, start_method="spawn")
    with open(os.path.join(tmp, "row.json")) as f:
        return tuple(json.load(f))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help="locality window of the local graph "
                         "(default max(n/64, 32))")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank; the default) or "
                         "cpu (gloo)")
    ap.add_argument("--no-time", action="store_true",
                    help="the comms columns only (no solve is timed)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    n, r = args.n, args.rank
    window = args.window or max(n // 64, 32)
    dev = torch.device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and not args.no_time and cards == 0:
        raise RuntimeError("--device cuda but no card is present; pass "
                           "--device cpu or --no-time")
    rows = []
    for kind, A in _graphs(n, args.deg, window).items():
        for nd in (1, 2, 4, 8):
            cp = _compile(A, nd)
            layouts = [("allgather", False)]
            if nd > 1 and cp.halo_send is not None:
                layouts.append(("halo", True))
            for lname, halo in layouts:
                row = {
                    "kind": kind, "nd": nd, "layout": lname, "n": n,
                    "deg": args.deg,
                    "window": window if kind == "local" else None,
                    "n_pad": cp.n_pad, "halo_H": cp.halo_H if nd > 1 else 0,
                    "comms_words_per_pass_per_device": comms_words(
                        cp, nd, r, halo),
                    "per_step_s": None, "steps": None, "time_note": None,
                }
                if args.no_time:
                    row["time_note"] = "not timed (--no-time)"
                elif dev.type == "cuda" and nd > cards:
                    row["time_note"] = (f"not measured: {nd} ranks need {nd} "
                                        f"cards, the machine has {cards}")
                elif nd == 1:
                    row["per_step_s"], row["steps"] = time_steps(
                        cp, r, args.steps, args.device)
                else:
                    row["per_step_s"], row["steps"] = time_world(
                        nd, args.device, dict(
                            kind=kind, n=n, deg=args.deg, window=window,
                            r=r, steps=args.steps, halo=halo))
                rows.append(row)
                print(json.dumps(row), flush=True)
    out = {
        "commit": repo_commit(),
        "backend": ("gloo-cpu" if dev.type == "cpu" else "nccl-cuda"),
        **device_info(args.device if not args.no_time else "cpu"),
        "note": ("time = the host program per inner step (work division "
                 "and collective overhead); comms = exact words received "
                 "per rank per operator pass"),
        "rows": rows,
    }
    path = args.out or os.path.join(OUTPUT, "_live", "scaling_halo.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {path}")
    return out


if __name__ == "__main__":
    main()
