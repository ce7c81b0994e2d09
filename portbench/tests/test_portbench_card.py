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
