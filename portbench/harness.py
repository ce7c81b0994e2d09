"""One run of one cell: set-up, the measured window, the traced
sub-window, the per-layer probes, the check, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

* configuration ``<c>``: the ``file`` of its entry (``configs/<c>.json``):
  problem and, optionally, its ``"params"``, graph family and parameters,
  solver settings, check limits;
* graph family ``<f>`` named by a configuration: ``families/<f>.py``;
* problem ``<p>``: its plain reference, ``reference/<p>.py``, whose
  ``formulation(graph, **params)`` returns an ``instance.Instance``,
  whose ``certify(instance, R, λ)`` returns the check's readings, and
  whose ``certify_tf32(instance, R, λ)`` returns the same readings in
  TF32, the check's control (``control.py``);
* traffic mix ``<t>``: ``mixes/<t>.json`` (pool size, per-solve maxtime,
  traced solves);
* per-layer metric ``<m>``: ``metrics/<m>.py``, whose ``read(ctx)``
  returns the number or None where the run has nothing to read (the
  metric is then left out of the line).

A metric whose entry has no ``workloads`` list comes with every cell,
those added later too: the per-layer metrics that read what every solve
path has (the solves' preprocessing time and dual passes, the
``sdplr.*`` spans, the trace's idle share) need no edit for a new cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
import types

import numpy as np

from . import check, endtoend, port, trace
from .instance import resolve_trace_bound

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by its path (a name may hold
    dots and dashes)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MIX_KEYS = {"loop", "pool", "maxtime_s", "trace_solves"}
WARMUP_TOL = 1.0    # the upstream protocol's warm-up: one solve at tol 1.0


def load_cell(root: str, workload: str):
    """(manifest, workload entry, configuration, mix). A mix is a closed
    loop of one client over its pool; a key the harness does not honour is
    refused."""
    man = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    mix = load_json(os.path.join(HERE, "mixes", f"{cell['traffic']}.json"))
    check_mix(cell["traffic"], mix)
    return man, cell, config, mix


def check_mix(name: str, mix: dict) -> None:
    if set(mix) != MIX_KEYS or mix["loop"] != "closed":
        raise ValueError(f"mix {name!r}: keys {sorted(mix)}, loop "
                         f"{mix.get('loop')!r}; the harness runs a closed "
                         f"loop of one client with keys {sorted(MIX_KEYS)}")


def metrics_of(entries: list, workload: str) -> list:
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def make_pool(config: dict, mix: dict, rng: np.random.Generator) -> list:
    """The instance pool: [Instance], each with the trace bound that the
    configuration's ``solver.trace_bound`` states for it. The pool is
    fixed, as Gset's files are: instance j is the family's draw with seed
    j. The run's seed only chooses the order in which the loop visits it
    (and, in ``Loop``, each solve's solver seed), so every run does the
    same work."""
    family = load_module("families", config["family"])
    ref = check.reference(config["problem"])
    params = config.get("params", {})
    order = rng.permutation(int(mix["pool"]))
    pool = []
    for j in order:
        inst = ref.formulation(family.graph(config["graph"], int(j)),
                               **params)
        tb = resolve_trace_bound(config["solver"]["trace_bound"], inst)
        pool.append(dataclasses.replace(inst, trace_bound=tb))
    return pool


def record(i: int, j: int, seed: int, wall: float, res: dict | None,
           solver: dict, error: str | None = None) -> dict:
    """What the metrics and the check keep of one solve."""
    if res is None:
        return {"i": i, "instance": j, "seed": seed, "wall_s": wall,
                "certified": False, "error": error, "R": None}
    certified = (not res["timed_out"]
                 and res["primal_vio"] <= float(solver["ptol"])
                 and res["rel_duality_gap"] <= float(solver["objtol"]))
    obj = res["obj_feasible"]
    return {
        "i": i, "instance": j, "seed": seed, "wall_s": wall,
        "certified": bool(certified), "timed_out": bool(res["timed_out"]),
        "iter": int(res["iter"]), "majoriter": int(res["majoriter"]),
        "dual_passes": int(res["dual_passes"]),
        "preprocess_s": float(res["preprocess_time"]), "r": int(res["r"]),
        "engine": res["inner_engine"],
        "claims": {"obj": float(res["obj"] if obj is None else obj),
                   "bound": float(res["max_dual_value"]),
                   "pinfeas": float(res["primal_vio"]),
                   "gap": float(res["rel_duality_gap"])},
        "R": np.asarray(res["R"], np.float64),
        "lam": np.asarray(res["lambda"], np.float64),
    }


class Loop:
    """The closed loop over the pool: solve i takes instance i mod pool,
    with its constraints as the port's operands (``operands[j]``, made in
    set-up), and the i-th solver seed."""

    def __init__(self, pool, operands, config, mix, rng, device):
        self.pool, self.operands, self.device = pool, operands, device
        self.solver, self.mix = config["solver"], mix
        self.seeds = iter(rng.integers(0, 2**31 - 1, size=1 << 20))
        self.next = 0

    def solve(self, tol: float | None = None) -> dict:
        """The next solve; ``tol`` replaces the protocol's ptol and objtol
        (the warm-up's)."""
        i, self.next = self.next, self.next + 1
        j = i % len(self.pool)
        seed = int(next(self.seeds))
        solver = self.solver if tol is None else dict(
            self.solver, ptol=tol, objtol=tol)
        t0 = time.perf_counter()
        try:
            res = port.solve(self.pool[j], self.operands[j], solver,
                             seed=seed, maxtime=float(self.mix["maxtime_s"]),
                             device=self.device)
            error = None
        except (RuntimeError, ValueError, FloatingPointError) as e:
            res, error = None, f"{type(e).__name__}: {e}"
        wall = time.perf_counter() - t0
        return record(i, j, seed, wall, res, solver, error)


class Run:
    """A cell's set-up (the pool from the seed, its constraints as the
    port's operands, the warm-up solve) and its measured window. As the
    upstream protocol does, the warm-up solves the pool's first instance
    at ptol = objtol = WARMUP_TOL: it loads every library and kernel the
    solves use at a fraction of a solve's time."""

    def __init__(self, root: str, workload: str, seed: int, *,
                 device: str = "cuda", warm: bool = True):
        import torch

        self.man, self.cell, self.config, self.mix = load_cell(root,
                                                              workload)
        rng = np.random.default_rng(int(seed))
        self.pool = make_pool(self.config, self.mix, rng)
        self.operands = port.operands(self.pool)
        self.on_card = torch.device(device).type == "cuda"
        self.loop = Loop(self.pool, self.operands, self.config, self.mix,
                         rng, device)
        if warm:
            self.loop.solve(tol=WARMUP_TOL)
        self.loop.next = 0     # the window starts again at the pool's head
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def window(self, seconds: float, traced: bool = False):
        """(records, window seconds, reduced trace, counter deltas). A
        traced run first solves the mix's traced solves under the profiler
        and reduces the trace; its window of ``seconds`` follows them."""
        records, tr, counts = [], None, None
        if traced:
            tr = {}
            before = port.counters()
            with trace.traced(tr):
                for _ in range(int(self.mix["trace_solves"])):
                    records.append(self.loop.solve())
            counts = port.counters() - before
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < seconds:
            records.append(self.loop.solve())
        return records, time.perf_counter() - t_open, tr, counts


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, *, t0: float, device: str = "cuda") -> dict:
    """Run one cell and return the result line (a dict) with its check
    under ``check`` and the lines for standard error under ``_stderr``."""
    import torch

    run = Run(root, workload, seed, device=device)
    setup = time.time() - t0
    records, window, tr, counts = run.window(seconds, traced)
    on_card = run.on_card
    mem = int(torch.cuda.max_memory_allocated()) if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
    man, cell, config, mix, pool = (run.man, run.cell, run.config, run.mix,
                                    run.pool)
    n_traced = int(mix["trace_solves"]) if traced else 0

    ctx = types.SimpleNamespace(
        config=config, mix=mix, pool=pool, records=records,
        traced=records[:n_traced], counts=counts, trace=tr, setup_s=setup,
        window_s=window, device=device, on_card=on_card,
        operands=run.operands, _probes={})
    ctx.probe = lambda name: _probe(ctx, name)

    if traced:
        entries = metrics_of(man["per_layer"], workload)
        values = {m["name"]: load_module("metrics", m["name"]).read(ctx)
                  for m in entries}
    else:
        entries = metrics_of(man["end_to_end"], workload)
        values = {m["name"]: endtoend.METRICS[m["name"]](ctx)
                  for m in entries}
    metrics = {m["name"]: {"value": float(values[m["name"]]),
                           "unit": m["unit"]}
               for m in entries if values[m["name"]] is not None}

    correct, table, checked = check.judge(records, pool, config, seed)
    line = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(1 for s in records if not s["certified"]),
        "metrics": metrics,
        "device": _device(device, int(cell["chips"]), mem, tr),
    }
    if traced:
        line["breakdown"] = trace.breakdown(tr)
    line["card"] = _card(on_card)
    line["check"] = {k: {"value": v, "limit": l} for k, (v, l)
                     in table.items()}
    line["_stderr"] = [f"check: {len(checked)} of {len(records)} solves "
                       f"against the float64 reference"] + [
        f"check {k}: {v!r} (limit {l!r}) {'ok' if v <= l else 'FAILED'}"
        for k, (v, l) in table.items()]
    return line


def _probe(ctx, name: str):
    """A measurement the harness makes after the window, once per run, for
    the metrics that read it; a device measurement is None off the card."""
    if name not in ctx._probes:
        if name == "n_pad":
            ctx._probes[name] = port.n_pad(ctx.pool[0], ctx.operands[0])
        elif not ctx.on_card:
            ctx._probes[name] = None
        elif name == "inner_step":
            solver = ctx.config["solver"]
            ctx._probes[name] = port.inner_step_probe(
                ctx.pool[0], ctx.operands[0], r=int(solver["r0"]),
                k=int(solver["lbfgs_pairs"]), dtype=solver["dtype"],
                device=ctx.device)
        else:
            raise KeyError(f"no probe {name!r}")
    return ctx._probes[name]


def _device(device: str, chips: int, mem: int, tr: dict | None) -> dict:
    import torch

    on_card = torch.device(device).type == "cuda"
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": mem}
    if tr is not None:
        out["busy_s"] = tr["busy_s"]
        out["window_s"] = tr["window_s"]
    return out


def _card(on_card: bool) -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    if not on_card:
        return None
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
