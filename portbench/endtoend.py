"""End-to-end metrics: what a user of the solver sees, on the host's clock.

A run is a closed loop: one client solves the pool's instances back to
back. Solves start while less than ``--seconds`` have passed since the
window opened; the window closes when the last started solve returns.

* ``setup_s``: process start to the first timed solve: the instance
  pool, the port's import and kernel loads (builds on a checkout's first
  run), the warm-up solves.
* ``solve_s``: the window's wall time over the certified solves
  completed in it. A solve that fails costs its time and counts for
  nothing.
* ``solve_s_p90``: the 90th percentile of the window's per-solve wall
  times, a failed solve counting as above any limit (as the larger of its
  wall time and its ``maxtime``).
"""

from __future__ import annotations

import math


def setup_s(ctx) -> float:
    return ctx.setup_s


def solve_s(ctx) -> float | None:
    done = sum(1 for s in ctx.records if s["certified"])
    return ctx.window_s / done if done else None


def solve_s_p90(ctx) -> float | None:
    t = sorted(s["wall_s"] if s["certified"]
               else max(s["wall_s"], ctx.mix["maxtime_s"])
               for s in ctx.records)
    if not t:
        return None
    # nearest rank: the least time that 90 % of the solves do not exceed
    return t[max(math.ceil(0.9 * len(t)) - 1, 0)]


METRICS = {"setup_s": setup_s, "solve_s": solve_s,
           "solve_s_p90": solve_s_p90}
