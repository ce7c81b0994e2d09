"""Warm-start against restart rank doubling, on Lovász θ by default.

Counterpart of the JAX package's ``exps/rank_mode_study.py``: each graph
is solved in both rank-update modes (``warm``, the default, keeps the
factor and pads it with small random columns; ``restart``, the
reference's behaviour, src/coreop.jl:518-526, draws a fresh factor)
through the CLI's ``run_one``, after one warm-up at the real tolerances,
and a summary JSON is written. If warm does not cut the inner iterations
or the time to tolerance, the default should go back to restart.

A graph is a Gset name (read from ``--data-root``, as the CLI reads it)
or a generator spec ``KIND:N:DEG`` of the CLI's synthetic graphs
(``random``, ``local``, ``cyclepow``, ``cliques``; e.g. ``cyclepow:72:2``
is C₇₂², θ = 24).

    python -m sdplrplus_tpu_torch.exps.rank_mode_study \\
        --graphs cyclepow:72:2 cliques:120:6 [--maxtime 900] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .common import OUTPUT, setup_cache
from .run import artifact_name, load_graph, run_one, synthetic_instance

MODES = ("warm", "restart")


def graph_of(spec: str, args):
    """(name, adjacency) of a Gset name or a ``KIND:N:DEG`` spec."""
    parts = spec.split(":")
    if len(parts) == 3:
        kind, n, deg = parts[0], int(parts[1]), int(parts[2])
        return f"{kind}-{n}-{deg}", synthetic_instance(kind, n, deg)
    return spec, load_graph(args, spec, args.problem)


def parse_args(argv=None):
    from ..utils.io import DATA_ROOT

    p = argparse.ArgumentParser()
    p.add_argument("--graphs", nargs="+", default=["cyclepow:72:2"])
    p.add_argument("--problem", default="LovaszTheta",
                   choices=["LovaszTheta", "MaxCut"])
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--maxtime", type=float, default=900.0)
    p.add_argument("--ptol", type=float, default=1e-2)
    p.add_argument("--objtol", type=float, default=1e-2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-root", default=DATA_ROOT)
    p.add_argument("--output", default=os.path.join(OUTPUT, "_live"))
    args = p.parse_args(argv)
    # what else run_one reads of the CLI's arguments
    args.seed, args.dtype, args.mu, args.devices, args.synthetic_n = \
        0, None, 0.1, 1, 0
    return args


def main(argv=None) -> list:
    args = parse_args(argv)
    setup_cache()
    rows = []
    for spec in args.graphs:
        graph, A = graph_of(spec, args)
        run_one(args, graph, A, "SDPLRTORCH-warmup", args.ptol, args.objtol,
                printlevel=0)
        for mode in MODES:
            t0 = time.time()
            res = run_one(args, graph, A, f"{artifact_name(args)}-{mode}",
                          args.ptol, args.objtol, printlevel=0,
                          rank_update_mode=mode)
            row = dict(
                graph=graph, mode=mode, obj=res["obj"],
                primal_vio=res["primal_vio"],
                rel_duality_gap=res["rel_duality_gap"], iter=res["iter"],
                majoriter=res["majoriter"], final_rank=res["r"],
                wall_s=time.time() - t0, totaltime=res["totaltime"],
                timed_out=res["timed_out"],
                inner_engine=res["inner_engine"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = os.path.join(args.output, f"rank_mode_study_{args.problem}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"-> {out}")
    return rows


if __name__ == "__main__":
    main()
