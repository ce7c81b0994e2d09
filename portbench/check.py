"""The check that decides ``correct``: the solves of the window, judged
by the plain float64 reference once the window has closed.

The solves checked are every failed one, the longest one, and a sample
of the rest drawn from the run's seed, up to the configuration's
``check.sample``. For each the reference works out, from the factor R
and the multipliers λ that the solve returned, what they certify
(``reference/<problem>.py``), and sets that beside what the solve
claimed. The numbers compared, each the worst over the solves checked:

* ``pinfeas``: the primal infeasibility of R; limit the protocol's ptol;
* ``gap``: the relative gap between the objective of R made exactly
  feasible and the dual bound of λ; limit the protocol's objtol;
* ``obj_dev``: |claimed objective − reference's| / |reference's|;
* ``pinfeas_dev``: |claimed pinfeas − reference's| / ptol;
* ``bound_over``: (claimed bound − reference's) / |reference's|, > 0
  where the claimed certificate is stronger than λ gives.

A limit named ``<number>_median`` holds the median of ``<number>`` over
the solves checked in place of its worst: a number whose worst swings
with a rare solve is compared by where its bulk lies. The limits but
``pinfeas`` and ``gap`` are the configuration's, set from readings of
sound runs and of the control (``control.py``), as ``PERF.md`` records.
"""

from __future__ import annotations

import importlib

import numpy as np


def reference(problem: str):
    return importlib.import_module(f"portbench.reference.{problem}")


def choose(records: list, sample: int, seed: int) -> list:
    """Indices of the solves to check."""
    if not records:
        return []
    pick = {i for i, s in enumerate(records) if not s["certified"]}
    pick.add(max(range(len(records)), key=lambda i: records[i]["wall_s"]))
    rest = [i for i in range(len(records)) if i not in pick]
    rng = np.random.default_rng([int(seed), 7])
    more = max(sample - len(pick), 0)
    if rest and more:
        pick.update(int(i) for i in rng.choice(rest, min(more, len(rest)),
                                               replace=False))
    return sorted(pick)


def numbers(ref: dict, claims: dict, solver: dict) -> dict:
    ptol = float(solver["ptol"])
    return {
        "pinfeas": ref["pinfeas"],
        "gap": ref["gap"],
        "obj_dev": abs(claims["obj"] - ref["obj"]) / abs(ref["obj"]),
        "pinfeas_dev": abs(claims["pinfeas"] - ref["pinfeas"]) / ptol,
        "bound_over": (claims["bound"] - ref["bound"]) / abs(ref["bound"]),
    }


def limits(config: dict) -> dict:
    solver = config["solver"]
    lim = {"pinfeas": float(solver["ptol"]), "gap": float(solver["objtol"])}
    lim.update({k: float(v) for k, v in config["check"]["limits"].items()})
    return lim


MEDIAN = "_median"


def worst(rows: list) -> dict:
    """Each number's worst (largest) reading over ``rows``; a solve that
    returned nothing to judge reads +inf."""
    out = {}
    for row in rows:
        for k, v in row.items():
            v = float("inf") if v is None or not np.isfinite(v) else v
            out[k] = max(out.get(k, -float("inf")), v)
    return out


def read(rows: list, names) -> dict:
    """The reading of each of ``names`` over ``rows``: its worst, or for
    ``<number>_median`` the median of ``<number>`` (a solve that returned
    nothing to judge reads +inf there too)."""
    got = worst(rows)
    out = {}
    for k in names:
        if k.endswith(MEDIAN) and rows:
            base = k[:-len(MEDIAN)]
            vals = [r.get(base) for r in rows]
            vals = [float("inf") if v is None or not np.isfinite(v) else v
                    for v in vals]
            out[k] = float(np.median(vals))
        else:
            out[k] = got.get(k, float("inf"))
    return out


def claimed(inst, solve: dict) -> dict:
    """What the solve itself claimed."""
    return solve["claims"]


def judge(records: list, instances: list, config: dict, seed: int,
          claims_of=claimed) -> tuple:
    """(correct, {name: (reading, limit)}, solves checked).
    ``claims_of(instance, solve)`` gives the claims judged: the solve's
    own, or the control's (control.py). The reference gets the whole
    instance: ``certify(instance, R, λ)``."""
    ref = reference(config["problem"])
    solver = config["solver"]
    rows = []
    checked = choose(records, int(config["check"]["sample"]), seed)
    for i in checked:
        s = records[i]
        if s.get("R") is None:
            rows.append({k: None for k in limits(config)})
            continue
        inst = instances[s["instance"]]
        r = ref.certify(inst, s["R"], s["lam"])
        rows.append(numbers(r, claims_of(inst, s), solver))
    lim = limits(config)
    got = read(rows, lim)
    table = {k: (got[k], lim[k]) for k in lim}
    correct = bool(checked) and all(v <= l for v, l in table.values())
    return correct, table, checked
