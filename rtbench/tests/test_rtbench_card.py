"""One short run of a cell on the card, through the command the driver
runs. Skips where there is no CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rtbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "rtbench", "--workload",
         "cornell_dense_100k.ao_preview", "--seed", str(2**31 + 3),
         "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) >= {"setup_s", "frame_ms_p95"}
    assert list(res)[-1] == "checks"


def test_no_card_no_result():
    """Without a card the command exits with 3 and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "rtbench", "--workload",
         "cornell_dense_100k.pt", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout.strip() == ""
