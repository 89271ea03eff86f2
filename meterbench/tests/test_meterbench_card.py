"""One short run of each cell on the card, through the entry point.  Marked
``cuda``: skips where there is no card, deciding inside the test.  Run on
the card with ``python -m pytest meterbench/tests -m cuda``."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

from meterbench import manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this run belongs on the chip")
    proc = subprocess.run(
        [sys.executable, "meterbench/run.py", "--workload", cell, "--seed", str(2**31 + 77),
         "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu" and line["failed"] == 0
