"""Without a CUDA device a run fails and prints no result, and so does a
checkout that holds only BENCHMARK.json and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

from small import ROOT, STYLIZE


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "neube_bench.run", "--workload", STYLIZE,
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert "metrics" not in json.loads(line)
        except ValueError:
            pass


def test_no_card_no_result():
    import torch
    assert not torch.cuda.is_available()
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_benchmark_files_alone_no_result(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        paths = json.load(f)["paths"]
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in paths:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
