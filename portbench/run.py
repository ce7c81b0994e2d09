"""Run one cell of the port's benchmark and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. Without a CUDA
card (or with fewer than the cell asks for) it exits with code 2 and
prints no result; it never falls back to the CPU. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``;
then ``card`` and, last, ``check``); the check's numbers, each beside its
limit, are also the last lines of standard error. With ``--trace 0`` the
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones.
"""

from __future__ import annotations

import time

T0 = time.time()    # set-up is timed from here, before the heavy imports

import argparse     # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import sys          # noqa: E402

# one BLAS and OpenMP thread, as the upstream protocol enforces for the
# solver (exps/test.jl), set before NumPy and torch are imported: the
# host side of a solve is many small operations, which more threads only
# make noisier
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

FORBIDDEN = {"jax", "jaxlib", "flax", "sdplrplus_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``sdplrplus_tpu_torch`` is the port, not the JAX
    package)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "BENCHMARK.json")):
        print("no BENCHMARK.json in the working directory", file=sys.stderr)
        return 2

    from portbench import harness, port

    _, cell, _, _ = harness.load_cell(root, args.workload)
    port.use_build_dir(os.path.join(root, "portbench", "_build"))
    import torch

    want = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"{args.workload} needs {want} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    line = harness.run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for text in line.pop("_stderr"):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
