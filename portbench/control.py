"""Readings that set the check's limits (``PERF.md`` records them): for
each seed, one process runs the cell's set-up and a window at the cell's
own size and load, then judges the window's solves three ways.

* ``program``: the port's claims against the float64 reference, as a
  benchmark run judges them (the lower readings);
* ``control``: the problem's TF32 control, ``certify_tf32(instance, R,
  λ)`` of its reference (``reference/<problem>.py``), put in the port's
  place at the port's own factors and multipliers (the upper readings);
* with ``--fault``, the port's claims with the fault planted under the
  timed path (faults.py).

    python -m portbench.control --workload <name> --seconds <s> \\
        [--fault <name>] --seeds <n> <n> ...

Prints one JSON line per seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import faults


def control_of(config: dict):
    """The claims of the configuration's problem's TF32 control, as
    ``check.judge`` takes them (``claims_of``)."""
    from . import check

    problem = config["problem"]
    certify_tf32 = getattr(check.reference(problem), "certify_tf32", None)
    if certify_tf32 is None:
        raise LookupError(f"reference/{problem}.py has no certify_tf32("
                          "instance, R, lam): the problem brings no TF32 "
                          "control")
    return lambda inst, s: certify_tf32(inst, s["R"], s["lam"])


def readings(root: str, workload: str, seeds: list, seconds: float, *,
             fault: str | None = None, device: str = "cuda"):
    """Yield one dict of readings per seed."""
    from . import check, harness

    if fault is None:
        control_claims = control_of(harness.load_cell(root, workload)[2])
    for n, seed in enumerate(seeds):
        with faults.planted(fault) if fault else contextlib.nullcontext():
            run = harness.Run(root, workload, seed, device=device,
                              warm=n == 0)
            records = run.window(seconds)[0]
        out = {"seed": seed, "fault": fault, "solves": len(records),
               "failed": sum(1 for s in records if not s["certified"])}
        ok, table, checked = check.judge(records, run.pool, run.config, seed)
        out["checked"] = len(checked)
        out["program"] = {k: v for k, (v, _) in table.items()}
        out["correct"] = ok
        if fault is None:
            ok_c, table_c, _ = check.judge(records, run.pool, run.config,
                                           seed, claims_of=control_claims)
            out["control"] = {k: v for k, (v, _) in table_c.items()}
            out["control_correct"] = ok_c
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", choices=faults.READINGS)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    root = os.getcwd()
    from . import port

    port.use_build_dir(os.path.join(root, "portbench", "_build"))
    import torch

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    try:
        for out in readings(root, args.workload, args.seeds, args.seconds,
                            fault=args.fault):
            print(json.dumps(out), flush=True)
    except LookupError as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
