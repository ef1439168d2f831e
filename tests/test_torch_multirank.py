"""Data-parallel training of the port over two ranks, against one process.

Spawns a real 2-process ``torch.distributed`` gloo group on localhost
(``tests/torch_multirank_worker.py``), as ``tests/test_multihost.py`` does
for JAX, running the fused training loop on device banks for 3 batches at
a global batch of 8 (4 rows per rank) with Dr1, Gpl, Ggeom, ADA, random
noise, style mixing, ``masked_mean`` and ``mean_rgb`` losses and the
discriminator's minibatch-stddev in groups of 4 (each group spans both
ranks); then one process runs the same global schedule alone.  The
meaning held is the JAX package's: the two runs compute the same training
trajectory up to cross-process reduction order -- the trees' digests to
``rtol 1e-4``, the tick's stats to ``rtol 5e-3, atol 1e-4`` (the JAX test's
tolerances); both ranks hold the same state.  The 2-rank run saves its
state through the tensor-wise ("orbax") backend, and one process resumes
it and trains one batch more as the uninterrupted process does (the same
tolerance).  From the trained state both runs then take one Gstitch (its
discriminator passes see all of ``fake1`` and then all of ``fake2``, as one
process does), one Gstitch and one Dmain in two ``batch_gpu`` rounds of 4
(each round the global rows one process takes, 2 per rank): stats and
the updated tree's digest at the same tolerances.  Every worker has a 300-s
timeout and is killed past it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multirank_worker.py")
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, WORKER] + argv,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=env)


def _finish(procs):
    """Wait for every worker within the timeout; kill and fail on a hang."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a worker hung past {TIMEOUT} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def test_two_ranks_match_one_process_and_resume_in_one(tmp_path):
    multi, single = str(tmp_path / "multi.json"), str(tmp_path / "one.json")
    state = str(tmp_path / "state2")
    port = str(_free_port())
    # All three at once: the single process resumes the 2-rank state once
    # it is written.
    _finish([_spawn(["--world", "2", "--rank", str(r), "--port", port,
                     "--out", multi, "--save", state]) for r in range(2)]
            + [_spawn(["--world", "1", "--out", single, "--resume", state])])

    ranks = [json.load(open(f"{multi}.rank{r}")) for r in range(2)]
    with open(f"{single}.rank0") as f:
        want = json.load(f)
    assert [g["world"] for g in ranks] == [2, 2] and want["world"] == 1
    assert ranks[0]["nimg"] == ranks[1]["nimg"] == want["nimg"] == 3 * 8
    # The replicated state stays replicated.
    assert ranks[0]["digest"] == ranks[1]["digest"]
    got = ranks[0]
    for k, v in want["digest"].items():
        np.testing.assert_allclose(got["digest"][k], v, rtol=1e-4,
                                   err_msg=k)
    checked = 0
    for k, v in want["stats"].items():
        if not np.isfinite(v) or k.startswith(("Timing/", "Progress/")):
            continue
        np.testing.assert_allclose(got["stats"][k], v, rtol=5e-3, atol=1e-4,
                                   err_msg=k)
        checked += 1
    # Every phase reported: Dmain, Dr1, Gmain with its three items, Gpl
    # and Ggeom with its two.
    for k in ("Loss/r1_penalty", "Loss/pl_penalty",
              "Loss/forger/Gmain/l1_uvs", "Loss/forger/Gmain/rgb_uvs",
              "Loss/forger/Ggeom/bce_uvs"):
        assert k in want["stats"] and k in got["stats"], k
    assert checked >= 15
    assert want["stats"]["Progress/ada_p"] == got["stats"]["Progress/ada_p"]

    # Gstitch and the batch_gpu rounds under the group.
    for name, one in want["extra"].items():
        two = [g["extra"][name] for g in ranks]
        assert two[0]["digest"] == two[1]["digest"], name
        np.testing.assert_allclose(two[0]["digest"], one["digest"],
                                   rtol=1e-4, err_msg=name)
        assert len(one["stats"]) >= 2, name
        for k, v in one["stats"].items():
            np.testing.assert_allclose(two[0]["stats"][k], v, rtol=5e-3,
                                       atol=1e-4, err_msg=f"{name} {k}")
    assert set(want["extra"]) == {"stitch", "stitch_rounds", "dmain_rounds"}

    # The state saved by two ranks resumes in one process.
    assert want["resumed_nimg"] == 3 * 8
    for k, v in want["digest_more"].items():
        np.testing.assert_allclose(want["resumed_digest"][k], v, rtol=1e-4,
                                   err_msg=k)
