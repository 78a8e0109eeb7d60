"""The one command refuses to run without a card and prints no result."""
import os
import subprocess
import sys

from conftest import ROOT


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "danube-cold", "--seed", str(2 ** 31 + 7),
                        "--seconds", "51", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "CUDA device" in p.stderr
