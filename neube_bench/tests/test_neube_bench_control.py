"""The comparison that decides ``correct``, at a size the CPU holds: the
program passes; the control (the plain reference put in the program's
place in bfloat16) fails; and a run with the timed path broken underneath
fails, once for each fault the stylize cell can have."""

import torch

from small import run_small


def test_program_is_correct():
    r = run_small()
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_control_in_bfloat16_is_not_correct():
    r = run_small(impl="bfloat16")
    assert not r["correct"], r["checks"]


def _wrap(cell, fault):
    run_core = cell.engine._run_core

    def broken(geom, opts, **kw):
        return fault(run_core, geom, opts, kw)
    cell.engine._run_core = broken


def test_half_of_each_pass_left_out_is_not_correct():
    def half(run_core, geom, opts, kw):
        b = geom.shape[0]
        keep = max(1, b // 2)
        idx = torch.arange(b) % keep
        geom = geom[idx.to(geom.device)] if torch.is_tensor(geom) \
            else geom[idx.numpy()]
        return run_core(geom, opts, **kw)
    r = run_small(hook=lambda c: _wrap(c, half))
    assert not r["correct"], r["checks"]


def test_one_tile_altered_is_not_correct():
    state = {"done": False}

    def alter(run_core, geom, opts, kw):
        out = run_core(geom, opts, **kw)
        if not state["done"]:
            rgba = out["rgba"].clone()
            rgba[0, ..., :3] = (rgba[0, ..., :3] + 0.1) % 1.0
            out = {**out, "rgba": rgba}
            state["done"] = True
        return out

    r = run_small(hook=lambda c: _wrap(c, alter), seconds=0.0)
    assert not r["correct"], r["checks"]


def test_stored_features_not_read_is_not_correct():
    def unblended(run_core, geom, opts, kw):
        return run_core(geom, opts, **{**kw, "blended_features": None})
    r = run_small(hook=lambda c: _wrap(c, unblended))
    assert not r["correct"], r["checks"]
