"""In-process benchmark sweep of the port: every (problem, graph) pair in
ONE process.

Counterpart of the JAX package's ``exps/sweep.py``. One process keeps the
kernels built and loaded, cuBLAS started and the allocator warm across
runs, so one warm-up per problem family suffices (at tolerance 1.0, as
the JAX package's sweep takes it). Each run goes through the CLI's
``run_one`` (``exps/run.py``), so it writes the same JSON and
``_state.npz`` files, plus one summary line on stdout.

    python -m sdplrplus_tpu_torch.exps.sweep [--problems MaxCut CutNorm ...]
        [--graphs G1 G2 ...] [--synthetic-n 800 --deg 24]
        [--ptol 1e-2] [--objtol 1e-2] [--maxtime 900] [--device cpu]

With ``--synthetic-n`` the sweep solves the seeded synthetic graph of the
CLI (named ``SYN<n>`` unless ``--graphs`` names it). Returns 1 when a run
failed or missed its tolerance.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

from .common import OUTPUT, setup_cache
from .run import PROBLEMS, artifact_name, load_graph, run_one


def parse_args(argv=None):
    from ..utils.io import DATA_ROOT

    p = argparse.ArgumentParser(description="in-process sweep (port)")
    p.add_argument("--problems", nargs="+", choices=PROBLEMS,
                   default=["MaxCut", "MinimumBisection", "CutNorm",
                            "LovaszTheta", "MuConductance"])
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--graphs", nargs="+", default=None,
                   help="Gset names (default G1..G9), or the name of the "
                        "synthetic graph (default SYN<n>)")
    p.add_argument("--ptol", type=float, default=1e-2)
    p.add_argument("--objtol", type=float, default=1e-2)
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--maxtime", type=float, default=900.0)
    p.add_argument("--dtype", type=str, default=None,
                   help="float32 (also when omitted) or float64")
    p.add_argument("--data-root", type=str, default=DATA_ROOT)
    p.add_argument("--output", type=str,
                   default=os.path.join(OUTPUT, "_live"))
    p.add_argument("--synthetic-n", type=int, default=0)
    p.add_argument("--synthetic-kind", type=str, default="random",
                   choices=["random", "local", "cyclepow", "cliques"])
    p.add_argument("--deg", type=int, default=16)
    p.add_argument("--devices", type=int, default=1,
                   help="ranks to row-shard each solve over (see "
                        "exps.run --devices)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.graphs is None:
        args.graphs = ([f"SYN{args.synthetic_n}"] if args.synthetic_n
                       else [f"G{i}" for i in range(1, 10)])
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_cache()
    failures = []
    for prob_name in args.problems:
        run_args = argparse.Namespace(**vars(args), problem=prob_name)
        warmed = False
        for graph in args.graphs:
            if not args.synthetic_n:
                from ..utils.io import gset_path

                data_problem = ("MaxCut" if prob_name == "MuConductance"
                                else prob_name)
                path = gset_path(graph, problem=data_problem,
                                 root=args.data_root)
                if not os.path.exists(path):
                    print(f"[{prob_name}/{graph}] SKIP (no {path})")
                    continue
            try:
                A = load_graph(run_args, graph, prob_name)
                if not warmed:  # one warm-up per problem family
                    run_one(run_args, graph, A, "SDPLRTORCH-warmup", 1.0,
                            1.0, printlevel=0)
                    warmed = True
                t0 = time.time()
                res = run_one(run_args, graph, A, artifact_name(run_args),
                              args.ptol, args.objtol, printlevel=0)
                wall = time.time() - t0
                ok = (res["primal_vio"] <= args.ptol * 1.01
                      and res["rel_duality_gap"] <= args.objtol * 1.01)
                print(f"[{prob_name}/{graph}] obj={res['obj']:.4f} "
                      f"pinfeas={res['primal_vio']:.2e} "
                      f"gap={res['rel_duality_gap']:.2e} wall={wall:.2f}s "
                      f"iters={res['iter']} majors={res['majoriter']} "
                      f"{'TIMED-OUT ' if res.get('timed_out') else ''}"
                      f"{'OK' if ok else 'MISSED-TOL'}",
                      flush=True)
                if not ok:
                    failures.append(f"{prob_name}/{graph}: missed tolerance")
            except Exception as e:  # keep sweeping; report at the end
                traceback.print_exc()
                print(f"[{prob_name}/{graph}] FAIL: {type(e).__name__}: {e}",
                      flush=True)
                failures.append(f"{prob_name}/{graph}: {e}")
    print(f"\nsweep done; {len(failures)} failure(s)")
    for f in failures:
        print("  -", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
