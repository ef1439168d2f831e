"""No module of JAX or of the JAX package in the harness's process, and
nothing of the program in the reference's: compared by whole top-level
names (the part before the first dot), since the program's name begins
with the JAX package's.  Each in a fresh subprocess."""

import json
import subprocess
import sys

from small import ROOT

JAX_NAMES = {"jax", "jaxlib", "brushstroke_engine_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
"""


def _top_level_modules(body: str):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, body=body)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": "/tmp",
             "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_the_program():
    mods = _top_level_modules(
        "import neube_bench.reference.model, neube_bench.reference.stylize,"
        " neube_bench.weights, neube_bench.workcount.flops")
    assert not mods & JAX_NAMES
    assert "brushstroke_engine_torch" not in mods


def test_a_whole_cpu_run_of_the_harness_loads_no_jax():
    mods = _top_level_modules(
        "sys.path.insert(0, {!r})\n"
        "import small\n"
        "small.run_small(0.1, trace=True)\n".format(ROOT + "/neube_bench/tests"))
    assert "brushstroke_engine_torch" in mods       # the program did run
    assert not mods & JAX_NAMES
