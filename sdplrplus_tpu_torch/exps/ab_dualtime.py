"""Trajectory-matched dual-time A/B of the port: fused model against host
measurement.

Counterpart of the JAX package's ``exps/ab_dualtime.py``. The fused
driver computes its dual bounds inside the state machine and attributes
dual time from the counted operator passes times a modelled per-pass
cost (the three-pass unit of ``solver/outer.py``); the host driver
(``fused_outer=False``) wall-clocks each dual bound. Both drivers run
the same algorithm, so the same instance through both compares the
model with a measurement. A mismatch in (iter, majoriter,
dual_bounds_computed) marks the run not matched. The solves run on the
card unless ``--device cpu``.

    python -m sdplrplus_tpu_torch.exps.ab_dualtime [--n 20000] \\
        [--dtype float64] [--out FILE]

Without ``--n`` the instance is the G1-shaped graph
``make_random_graph(800, 0.83, seed=1)``. Writes the JSON under
``exps/output/_live/`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .common import OUTPUT, device_info, repo_commit, setup_cache


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dual-time A/B (port)")
    ap.add_argument("--n", type=int, default=0,
                    help="synthetic size (0: the G1-shaped graph)")
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--maxtime", type=float, default=1200.0)
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from .. import sdplr
    from ..config import require_device
    from ..models import make_random_graph, maxcut, synthetic_graph

    args = parse_args(argv)
    dev = require_device(args.device, "the A/B's device")
    setup_cache()
    if args.n:
        A = synthetic_graph(args.n, args.deg)
        tag = f"SYN{args.n}"
    else:
        A = make_random_graph(800, 0.83, seed=1)
        tag = "G1-shaped"
    n = A.shape[0]
    C, As, b = maxcut(A)
    common = dict(prior_trace_bound=float(n), ptol=1e-2, objtol=1e-2,
                  printlevel=0, dtype=args.dtype, maxtime=args.maxtime,
                  dataset=tag, device=args.device)

    def one(fused):
        # warm-up at the same tolerances (see bench.py's warm-up)
        sdplr(C, As, b, 10, fused_outer=fused, **common)
        t0 = time.time()
        res = sdplr(C, As, b, 10, fused_outer=fused, **common)
        wall = time.time() - t0
        return {
            "driver": "fused" if fused else "host",
            "wall_s": wall,
            "totaltime": res["totaltime"],
            "dual_time": res["dual_time"],
            "dual_time_estimated": bool(res.get("dual_time_estimated")),
            "dual_share": res["dual_time"] / max(res["totaltime"], 1e-9),
            "dual_passes": res.get("dual_passes"),
            "iter": res["iter"],
            "majoriter": res["majoriter"],
            "bounds": res["dual_bounds_computed"],
            "rel_duality_gap": res["rel_duality_gap"],
            "obj": res["obj"],
            "timed_out": res["timed_out"],
            "inner_engine": res["inner_engine"],
        }

    fused = one(True)
    host = one(False)
    matched = (
        fused["iter"] == host["iter"]
        and fused["majoriter"] == host["majoriter"]
        and fused["bounds"] == host["bounds"]
    )
    err = None
    if host["dual_share"] > 0:
        err = abs(fused["dual_share"] - host["dual_share"]) \
            / host["dual_share"]
    out = {
        "instance": tag, "n": n, "dtype": args.dtype,
        "commit": repo_commit(),
        **device_info(dev),
        "trajectory_matched": matched,
        "fused": fused,
        "host": host,
        "model_vs_measured_dual_share_rel_err": err,
        "note": ("fused.dual_time = counted passes x modelled per-pass "
                 "cost; host.dual_time = wall-clocked dual bounds"),
    }
    path = args.out or os.path.join(
        OUTPUT, "_live", f"ab_dualtime_{tag}_{args.dtype}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2, default=float)
    print(json.dumps(out, indent=2, default=float))
    print(f"-> {path}")
    return out


if __name__ == "__main__":
    main()
