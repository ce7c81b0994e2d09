"""On the card: one short run of each cell through the benchmark's own
command, whose last line has to be a correct result on the card.

    python -m pytest portbench/tests -m cuda
"""

import json
import os
import subprocess

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.HERE)
MAN = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_short_run_on_the_card(card, cell):
    out = subprocess.run(
        [*MAN["command"], "--workload", cell, "--seed", "2147483999",
         "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert list(line)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
def test_k2_is_not_launched_on_maxcut_g1(card):
    """The G1 MaxCut path runs K1 and never K2: over a short window of the
    cell, ``k2.launches`` stays where it was while ``k1.launches`` grows."""
    from portbench import port

    port.use_build_dir(os.path.join(ROOT, "portbench", "_build"))
    run = harness.Run(ROOT, "maxcut-g1.gset", 2147483998)
    before = port.counters()
    records = run.window(2.0)[0]
    after = port.counters()
    assert records and all(s["certified"] for s in records)
    assert after["k1.launches"] > before["k1.launches"]
    assert after["k2.launches"] == before["k2.launches"]
