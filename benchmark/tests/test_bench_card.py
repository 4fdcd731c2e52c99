"""On the card (skipped elsewhere): one short run of each cell through the
benchmark's command line, its last line read as the driver reads it.

    python3 -m pytest benchmark/tests -q -m card      # on the chip"""
import json
import os
import subprocess
import sys

import pytest

import cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = ["ffhq_adm.hmc8_inpaint", "ffhq_ldm.hmc8_inpaint_f32", "ffhq_adm.hmc32_inpaint"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run(card, cell):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2 ** 33 + 7), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["check"]
    assert set(line["metrics"]) == {m["name"] for m in cells.load(cell).end_to_end}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "check"
