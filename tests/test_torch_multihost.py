"""Two processes joined through parallel.multihost.initialize (a TCP
rendezvous on localhost, gloo on the CPU), each calling
``sdplr(..., devices=2)`` on the same problem: the multi-process SPMD
entry of the port (the JAX package's tests/test_multihost.py:96, there
two processes of jax.distributed)."""

import numpy as np

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.models import make_random_graph, maxcut
from torch_spmd_cases import launch_ranks


def test_two_process_sdplr_matches_single_process(tmp_path):
    """The two-rank solve ends where the one-process solve ends: the same
    inner iterations, the objective to 1e-8 relative and R to 1e-6 in
    float64; the group reports two processes and the result two
    devices."""
    got = launch_ranks(str(tmp_path), 2, ["sdplr"], multihost=True,
                       timeout=120)
    info, res = got["process_info"], got["sdplr"]
    assert info["process_count"] == 2 and info["backend"] == "gloo"
    assert res["devices"] == 2 and "+spmd" in res["inner_engine"]

    C, As, b = maxcut(make_random_graph(40, 0.5, seed=5))[:3]
    ref = sdplr(C, As, b, 3, device="cpu", dtype="float64", ptol=1e-4,
                objtol=1e-4, printlevel=0, prior_trace_bound=40.0)
    assert res["iter"] == ref["iter"]
    assert abs(res["obj"] - ref["obj"]) <= 1e-8 * abs(ref["obj"])
    np.testing.assert_allclose(np.asarray(res["R"]), ref["R"], atol=1e-6)
