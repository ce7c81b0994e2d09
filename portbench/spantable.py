"""Where a cell's traced solves spend their time, by the port's spans.

    python -m portbench.spantable --workload <name> --seeds <n> [<n> ...] \\
        [--out <file.jsonl>]

From the root of a checkout that holds ``BENCHMARK.json``. For each seed,
one process-wide set-up (as a benchmark run makes it), then the mix's
traced solves under the profiler, as a ``--trace 1`` run traces them.
Prints one JSON line per seed: the traced solves' wall times, the card's
busy and window seconds, the idle gaps by what the host was doing (the
result line's ``breakdown``), the share of idle time labelled ``host: no
operator open``, and per span and solve its count, wall, self and device
milliseconds, the idle time by innermost span (``spans.reduce``) and the
span metrics' readings. The float64 check is not made. Not part of a
benchmark run; on a checkout whose port opens no spans the tables are
empty and the wall times still compare.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

NO_OP = "host: no operator open"
METRICS = (("dual_bound_ms", "sdplr.dual_bound", "wall_s"),
           ("boundary_ms", "sdplr.boundary", "self_s"),
           ("driver_self_ms", "sdplr.solve", "self_s"),
           ("capture_ms", "sdplr.inner.capture", "wall_s"))


def table(root: str, workload: str, seed: int, device: str) -> dict:
    from . import harness, port, spans, trace

    port.use_build_dir(os.path.join(root, "portbench", "_build"))
    run = harness.Run(root, workload, seed, device=device)
    before = spans.program_totals() or {}
    out = {}
    with spans.traced(out):
        records = [run.loop.solve()
                   for _ in range(int(run.mix["trace_solves"]))]
    after = spans.program_totals() or {}
    n = len(records)
    tr, sp = out["trace"], out["spans"]
    idle = sum(tr["idle"].values())
    per = lambda x: round(1e3 * x / n, 3)
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    solves = delta.get(("sdplr.solve", "count"), 0)
    return {
        "workload": workload, "seed": seed, "solves": n,
        "wall_s": [r["wall_s"] for r in records],
        "certified": sum(1 for r in records if r["certified"]),
        "busy_s": tr["busy_s"], "window_s": tr["window_s"],
        "idle_s": idle,
        "no_op_share_of_idle": tr["idle"].get(NO_OP, 0.0) / idle
        if idle else None,
        "breakdown": trace.breakdown(tr),
        "span_solves": sp["solves"],
        "spans_per_solve": {
            name: {"count": round(row["count"] / n, 2),
                   "wall_ms": per(row["wall_s"]),
                   "self_ms": per(row["self_s"]),
                   "device_ms": per(row["device_s"])}
            for name, row in sorted(sp["by_name"].items())},
        "idle_by_span_ms": {k: per(v) for k, v in sorted(
            sp["idle_by_span"].items(), key=lambda kv: -kv[1])},
        "metrics": {m: 1e3 * delta.get((name, field), 0.0) / solves
                    for m, name, field in METRICS} if solves else {},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="also append each line to this file")
    args = p.parse_args(argv)
    root = os.getcwd()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA card; pass --device cpu to rehearse",
                  file=sys.stderr)
            return 2
    for seed in args.seeds:
        line = json.dumps(table(root, args.workload, seed, args.device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
