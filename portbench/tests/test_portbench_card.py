"""One short run of each cell on the card, through the benchmark's command:
it must print a result line whose numbers are within their limits. Skips on
a machine without a CUDA card (decided inside the test). Run on the card with

    python3 -m pytest portbench/tests -m card
"""

import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(2**32 + 17),
                           "--seconds", "3", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
