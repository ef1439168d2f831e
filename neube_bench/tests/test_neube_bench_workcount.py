"""The FLOP and byte arithmetic of ``neube_bench/workcount`` against hand
counts at small shapes, and against torch's own count of the reference's
plain convolutions; and the trace reductions on made-up intervals."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from small import small_cell
from neube_bench import weights as W
from neube_bench.reference import model
from neube_bench.trace import Trace, union
from neube_bench.workcount import flops, peaks


def _layers(cfg, batch=1):
    return {name: f for name, _, f in flops.forward_layers(cfg, batch)}


def test_forward_layers_by_hand():
    _, _, cfg, _ = small_cell()
    got = _layers(cfg)
    assert got["encoder.layer0"] == 2 * 49 * 1 * 8 * 32 * 32
    assert got["encoder.layer1"] == 2 * 9 * 8 * 16 * 16 * 16
    assert got["encoder.layer5"] == 2 * 9 * 8 * 4 * 4 * 4
    assert got["decoder.up0"] == 2 * 9 * 4 * 16 * 8 * 8
    assert got["mapping"] == 8 * 2 * 64 * 64
    # b8.conv0: in = 32 trunk + 4 geometry channels, out 32, up=2 from 4 px.
    assert got["b8.conv0"] == 2 * 9 * 36 * 32 * 16 + 2 * 64 * 36 \
        + 2 * 36 * 32
    assert got["b8.conv1"] == 2 * 9 * 32 * 32 * 64 + 2 * 64 * 32 \
        + 2 * 32 * 32
    assert got["b32.torgb"] == 2 * 16 * 3 * 32 * 32 + 2 * 64 * (16 + 9)
    assert flops.forward_flops(cfg, 3) == 3 * sum(got.values())


def test_encoder_and_mapping_match_torchs_count():
    _, _, cfg, _ = small_cell()
    trees = W.make_trees(cfg, 5, "cpu")
    geom = torch.ones(2, 1, 32, 32)
    with FlopCounterMode(display=False) as fc:
        model.encode(cfg, trees["enc_params"], trees["enc_state"], geom,
                     torch.float32)
    want = sum(f for n, _, f in flops.forward_layers(cfg, 2)
               if n.startswith(("encoder.", "decoder.")))
    assert fc.get_total_flops() == want
    with FlopCounterMode(display=False) as fc:
        model.mapping(cfg, trees["gen_params"], torch.ones(2, 64),
                      torch.float32)
    assert fc.get_total_flops() == _layers(cfg, 2)["mapping"]


def test_k1_bytes_and_bound_by_hand():
    _, _, cfg, _ = small_cell()
    rows = flops.k1_launches(cfg, 1)
    assert [r for r, _, _ in rows] == [8, 16, 32]
    r, nbytes, ops = rows[0]
    assert nbytes == 11 * 11 * 32 * 4 + 8 * 8 * 32 * 4 + 8 * 8 * 4 \
        + 32 * 4 + 32 * 4
    assert ops == 8 * 8 * 32 * 38
    bound = flops.k1_bound_seconds(cfg, 1, peaks.HBM_BYTES_PER_S,
                                   peaks.FLOPS_PER_S["f32"])
    assert bound == sum(max(b / 3.35e12, f / 67e12) for _, b, f in rows)


def test_least_seconds_uses_each_parts_peak():
    _, _, cfg, _ = small_cell()
    enc = sum(f for _, p, f in flops.forward_layers(cfg, 1)
              if p == "encoder")
    gen = flops.forward_flops(cfg, 1) - enc
    assert abs(flops.least_seconds(cfg, 1, peaks.FLOPS_PER_S)
               - (enc / 989e12 + gen / 495e12)) < 1e-18
    strict = dict(cfg, precision="strict")
    assert abs(flops.least_seconds(strict, 1, peaks.FLOPS_PER_S)
               - (enc + gen) / 67e12) < 1e-18


def test_trace_union_and_idle_gaps():
    assert union([(0, 2), (1, 3), (5, 6)])[0] == 4
    dev = [("k", 1.0, 2.0), ("k", 1.5, 3.0), ("m", 5.0, 6.0)]
    host = [("outer", 0.0, 10.0), ("inner", 3.5, 4.5), ("late", 6.5, 9.0)]
    tr = Trace(10.0, dev, host, (0.0, 10.0))
    assert tr.busy_s == 3.0
    assert tr.device_seconds(lambda n: n == "k") == (2.5, 2)
    gaps = dict(tr.idle_gaps())
    # [0, 1] and [3, 5] and [6, 10]: mid-points 0.5, 4.0 and 8.0.
    assert gaps == {"outer": 1.0, "inner": 2.0, "late": 4.0}


def test_k2_bytes_and_operations_by_hand():
    nbytes, ops = flops.k2_launch(2, 8, 3, [(1.0, 1.0), (1.5, 1.0)])
    assert nbytes == 2 * 2 * 8 * 8 * 3 * 4 + 2 * 8 * 4
    assert ops == ((3 + 3) + (4 + 3)) * 8 * 8 * (4 + 2 * 3)


def test_pass_shares_count_tiles_over_untraced_time():
    """``mfu.stylize`` counts the tiles, not the padded rows, and both it
    and ``idle_share.stylize`` divide by the untraced drawings' seconds,
    not by the traced window that the profiler stretches."""
    from neube_bench import run
    _, _, cfg, _ = small_cell()
    tr = Trace(9.0, [("k", 0.0, 0.6)], [], (0.0, 9.0))
    ctx = {"cfg": cfg, "trace": tr,
           "counters": {"trace_passes": [32] * 12, "trace_tiles": 300,
                        "host_tiles": 600, "host_seconds": 2.0}}
    per_tile = flops.least_seconds(cfg, 1, peaks.FLOPS_PER_S)
    mfu = run.reader("mfu.stylize")(ctx)
    assert abs(mfu - 100.0 * 600 * per_tile / 2.0) < 1e-9 * mfu
    # 0.6 s busy over 300 tiles against 2.0 s over 600: 0.6 of the time.
    assert abs(run.reader("idle_share.stylize")(ctx) - 40.0) < 1e-9
    ctx["counters"].update(host_tiles=0, host_seconds=0.0)
    assert run.reader("mfu.stylize")(ctx) is None
    assert run.reader("idle_share.stylize")(ctx) is None
