"""The port's drawing server against the JAX package's on the CPU.

The same message sequences go through the JAX tornado server and the port's
tornado shell (``brushstroke_engine_torch/ui``) on each of the four image
paths (helper, device canvas, ``RenderBatcher``, the pooled device canvas),
both servers reading one native bundle (the JAX ``small_bundle`` weights at
32 px with non-zero noise strengths, carried into the port by
``params_from_jax``).  Then the protocol, the mock server, the batchers'
semantics, the timing side channel, the gating, the import boundary,
``save_native`` and the three repairs of this slice (``draw_stroke_into``'s
one-point stroke, the icon cache, the launch counters).

Tolerances: uint8 replies within 1 LSB (the same f32 math in another order
can round across a step), JSON replies and reply metadata exactly equal;
f32 RGBA within 1e-5 abs.  The JAX side runs in strict f32, the port's with
TF32 off.  Stroke positions are even: the JAX package's jitted
``wrapped_const_noise`` reads wrong texels on the CPU at x or y = 17, 21,
25, 29 (mod 32) at this size (``tests/test_torch_canvas.py``).
"""

import asyncio
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

import tornado.httpclient
import tornado.httpserver
import tornado.testing
import tornado.websocket

import jax

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.ui import protocol as jprotocol
from brushstroke_engine_tpu.ui import server as jserver
from brushstroke_engine_tpu.utils import checkpoint as jckpt
from brushstroke_engine_torch.data import curves
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine import device_canvas as tdev
from brushstroke_engine_torch.engine import library as tlib
from brushstroke_engine_torch.ops import cuda_build
from brushstroke_engine_torch.ops import fir_epilogue as fe
from brushstroke_engine_torch.ops import warp as tw
from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.ui import core as tcore
from brushstroke_engine_torch.ui import protocol as tprotocol
from brushstroke_engine_torch.ui import server as tserver
from brushstroke_engine_torch.utils import checkpoint as tckpt
from tests.helpers import small_bundle
from tests.torch_helpers import small_model

jset("strict")
set_precision_mode("strict")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PW = 32
CANVAS = 96
CROP = 4
# Even positions (see the module doc); the second and third overlap the
# first, so they blend with stored features.
STROKES = ((0, 0), (16, 8), (24, 20))


def u8_close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def bar_patch(seed, w=PW):
    rng = np.random.default_rng(seed)
    patch = np.zeros((w, w, 4), np.uint8)
    y = rng.integers(4, w - 12)
    patch[y:y + 8, 4:w - 4, 3] = 255
    return patch


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One native bundle (written by the JAX package) and a seed library."""
    d = tmp_path_factory.mktemp("server")
    bundle = small_bundle()
    for block in bundle.gen_params["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in block:
                block[name]["noise_strength"] = np.float32(0.4)
    path = str(d / "bundle.pkl")
    jckpt.save_native(path, bundle)
    seeds = str(d / "seeds.txt")
    with open(seeds, "w") as f:
        f.write("1\n2\n3\n")
    return {"bundle": path, "seeds": seeds}


@pytest.fixture(scope="module")
def tengine(files):
    return tbrush.PaintEngineFactory.create(files["bundle"], device="cpu")


# ----- running servers and clients -----

async def _listen(app):
    sock, port = tornado.testing.bind_unused_port()
    server = tornado.httpserver.HTTPServer(app)
    server.add_sockets([sock])
    return server, port


async def _connect(port):
    ws = await tornado.websocket.websocket_connect(
        f"ws://localhost:{port}/websocket/")
    return ws, [json.loads(await ws.read_message()) for _ in range(2)]


async def _recv(ws):
    msg = await ws.read_message()
    if isinstance(msg, bytes):
        rtype, meta, img = jprotocol.decode_render_response(msg)
        return ("binary", rtype, meta, img.copy())
    return ("json", json.loads(msg))


async def _converse(port, sessions):
    """The same sequence for ``sessions`` concurrent clients: connect,
    configure, a brush by seed and one from the library, then the strokes,
    round by round (every session sends its stroke, then every session
    reads its reply).  Returns each session's transcript."""
    conns, logs = [], []
    for i in range(sessions):
        ws, hello = await _connect(port)
        log = [("json", m) for m in hello]
        for msg in ({"type": "set_option", "option": "positions",
                     "value": True},
                    {"type": "new_canvas", "rows": CANVAS, "cols": CANVAS,
                     "feature_blending": 2}):
            ws.write_message(json.dumps(msg))
        for msg in ({"type": "set_brush", "seed": 7 + i},
                    {"type": "set_brush", "library_id": "Lib",
                     "style_id": str(2 + i)}):
            ws.write_message(json.dumps(msg))
            log.append(await _recv(ws))
        conns.append(ws)
        logs.append(log)
    for k, (x, y) in enumerate(STROKES):
        for i, ws in enumerate(conns):
            colors = [(0, 200, 30, 30)] if k == 1 else []
            ws.write_message(jprotocol.encode_render_request(
                bar_patch(10 * k + i), x, y, crop_margin=CROP,
                colors=colors, extra_data=k), binary=True)
        for i, ws in enumerate(conns):
            logs[i].append(await _recv(ws))
    for ws in conns:
        ws.close()
    return logs


def _parity(files, sessions, **kw):
    """Both servers through one sequence; returns the port's core."""
    specs = [["Lib", "disp", files["seeds"]]]

    async def run():
        japp = jserver.create_server(None, files["bundle"],
                                     library_specs=specs, style_seed=0, **kw)
        tapp = tserver.create_server(None, files["bundle"],
                                     library_specs=specs, style_seed=0,
                                     device="cpu", **kw)
        servers = []
        logs = []
        for app in (japp, tapp):
            server, port = await _listen(app)
            servers.append(server)
            logs.append(await _converse(port, sessions))
        for server in servers:
            server.stop()
        tapp.core.close()
        return logs, tapp.core

    (jlogs, tlogs), core = asyncio.run(run())
    for jlog, tlog in zip(jlogs, tlogs):
        assert len(jlog) == len(tlog) == 4 + len(STROKES)
        for j, t in zip(jlog, tlog):
            assert j[0] == t[0]
            if j[0] == "json":
                assert j == t
            else:
                assert j[1:3] == t[1:3]
                u8_close(j[3], t[3])
    assert core.fallbacks == 0 and core.errors == 0
    return core


def test_parity_helper_path(files):
    _parity(files, 1)


def test_parity_device_canvas_path(files):
    core = _parity(files, 1, use_device_canvas=True)
    assert core.use_device_canvas and core.dev_batcher is None


def test_parity_batched_path(files):
    core = _parity(files, 2, batch_window_ms=20.0)
    assert max(core.batcher.batch_sizes) > 1, core.batcher.batch_sizes


def test_parity_pooled_path(files):
    core = _parity(files, 2, use_device_canvas=True, batch_window_ms=20.0)
    assert max(core.dev_batcher.batch_sizes) > 1, \
        core.dev_batcher.batch_sizes
    assert not core.batcher.batch_sizes


# ----- protocol -----

def test_protocol_bytes_equal_the_jax_package():
    rng = np.random.RandomState(0)
    patch = (rng.rand(16, 12, 4) * 255).astype(np.uint8)
    kw = dict(x=5, y=-7, crop_margin=2, debug=True,
              colors=[(0, 255, 0, 0), (2, 0, 255, 9)], extra_data=3)
    raw = tprotocol.encode_render_request(patch, **kw)
    assert raw == jprotocol.encode_render_request(patch, **kw)
    for mod in (tprotocol, jprotocol):
        meta, offset = mod.decode_render_request_metadata(raw)
        pmeta, img, _ = mod.binary_to_image_patches(raw, offset)
        assert pmeta == {"width": 12, "height": 16, "x": 5, "y": -7,
                         "crop_margin": 2}
        assert meta["debug"] and meta["extra_data"] == 3
        np.testing.assert_array_equal(img, patch)
    out = tprotocol.int32_to_binary(4) + tprotocol.image_patch_to_binary(
        patch, 3, 4)
    assert out == jprotocol.int32_to_binary(4) + \
        jprotocol.image_patch_to_binary(patch, 3, 4)
    rtype, meta, img = tprotocol.decode_render_response(out)
    assert (rtype, meta) == (4, {"x": 3, "y": 4})
    np.testing.assert_array_equal(img, patch)


@pytest.mark.parametrize("arg", ["A:rand5:/tmp/a.pkl,B:disp:/tmp/b.txt",
                                 "/tmp/c.pkl", "N:/tmp/d.txt", "",
                                 "A:nope:/tmp/a.pkl", "A:b:c:d"])
def test_parse_libraries_agrees(arg):
    """Equal specs; a malformed one is refused by both."""
    try:
        want = jserver.parse_libraries(arg)
    except AssertionError:
        with pytest.raises(ValueError, match="Malformed"):
            tcore.parse_libraries(arg)
        return
    assert tcore.parse_libraries(arg) == want


# ----- the mock server -----

def _mock_requests(files, requests):
    """Fetch ``requests`` (paths, or a websocket coroutine factory) from the
    port's server with the mock engine."""
    app = tserver.create_server(
        None, None, library_specs=[["Lib", "disp", files["seeds"]]],
        device="cpu")

    async def run():
        server, port = await _listen(app)
        client = tornado.httpclient.AsyncHTTPClient()
        out = []
        for r in requests:
            if callable(r):
                out.append(await r(port))
            else:
                out.append(await client.fetch(
                    f"http://localhost:{port}{r}", raise_error=False))
        server.stop()
        return out

    return asyncio.run(run())


def test_mock_server_pages_and_render(files):
    async def render(port):
        ws, hello = await _connect(port)
        assert [m["type"] for m in hello] == ["modelinfo", "brushinfo"]
        pw = hello[0]["data"]["patch_width"]
        patch = np.zeros((pw, pw, 4), np.uint8)
        patch[10:30, 10:30, 3] = 255
        ws.write_message(tprotocol.encode_render_request(patch, x=0, y=0),
                         binary=True)
        reply = await _recv(ws)
        ws.close()
        return reply

    index, js, icon, reply = _mock_requests(
        files, ["/", "/static/app.js", "/brush/nope/1.jpg", render])
    assert index.code == 200
    body = index.body.decode()
    assert "strokeCanvas" in body and "Lib" in body
    assert js.code == 200 and b"getElementById" in js.body
    assert icon.code == 200 and icon.headers["Content-Type"] == "image/jpeg"
    kind, rtype, meta, img = reply
    assert kind == "binary" and rtype == 0 and img.shape == (256, 256, 4)
    assert (img[:3, :, 0] == 255).all()        # the mock engine's frame


def test_js_element_ids_exist_in_template():
    import re
    base = os.path.join(REPO, "brushstroke_engine_torch", "ui")
    js = open(os.path.join(base, "static", "app.js")).read()
    html = open(os.path.join(base, "templates", "home.html")).read()
    ids = set(re.findall(r"getElementById\([\"']([^\"']+)[\"']\)", js))
    ids |= set(re.findall(r"\$\([\"']([^\"']+)[\"']\)", js))
    assert ids
    assert not [i for i in ids if f'id="{i}"' not in html]
    for o, c in ("{}", "()", "[]"):
        assert js.count(o) == js.count(c)


# ----- the core, driven without a transport -----

class _Client:
    """A session of a core with its replies in a list."""

    def __init__(self, core):
        self.replies = []
        self.session = core.session(self.replies.append)
        self.session.open()

    async def json(self, **msg):
        await self.session.on_message(json.dumps(msg))

    async def stroke(self, patch, x, y, **kw):
        await self.session.on_message(tprotocol.encode_render_request(
            patch, x, y, **kw))

    def images(self):
        return [tprotocol.decode_render_response(m) for m in self.replies
                if isinstance(m, bytes)]

    def timings(self):
        return [m["data"] for m in self.replies
                if isinstance(m, dict) and m["type"] == "timing"]


async def _until(cond, timeout=30.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "reply missing"
        await asyncio.sleep(0.005)


async def _configured(core, seed, timing=False, level=2):
    c = _Client(core)
    await c.json(type="set_option", option="positions", value=True)
    await c.json(type="set_option", option="timing", value=timing)
    await c.json(type="new_canvas", rows=CANVAS, cols=CANVAS,
                 feature_blending=level)
    await c.json(type="set_brush", seed=seed)
    return c


@pytest.mark.parametrize("kw,path", [
    ({}, "helper"), ({"use_device_canvas": True}, "device_canvas"),
    ({"batch_window_ms": 5.0}, "batched"),
    ({"use_device_canvas": True, "batch_window_ms": 5.0},
     "device_batched")])
def test_timing_side_channel(tengine, kw, path):
    async def run():
        core = tcore.create_core(paint_engine=tengine, device="cpu", **kw)
        c = await _configured(core, 3, timing=True)
        for x, y in STROKES[:2]:
            await c.stroke(bar_patch(x), x, y, crop_margin=CROP)
            await _until(lambda: len(c.timings()) == len(c.images()) > 0
                         and len(c.images()) == STROKES.index((x, y)) + 1)
        await c.json(type="set_option", option="timing", value=False)
        await c.stroke(bar_patch(1), 48, 16, crop_margin=CROP)
        await _until(lambda: len(c.images()) == 3)
        await asyncio.sleep(0.02)
        core.close()
        return c, core

    c, core = asyncio.run(run())
    t = c.timings()
    assert [d["seq"] for d in t] == [0, 1]
    for d in t:
        assert d["path"] == path
        assert 0 <= d["queue_ms"] <= d["server_ms"]
        assert 0 < d["render_ms"] <= d["server_ms"]
        assert d["server_ms"] >= d["queue_ms"] + d["render_ms"] - 0.01
    assert len(t) == 2 and core.errors == 0   # none after opting out


def test_batchers_need_a_device_render_engine(tengine):
    """The batched and device paths are gated on the port's
    ``supports_device_render`` (the JAX server's ``_render_stroke_jax``
    hook has another name here)."""
    core = tcore.create_core(paint_engine=tengine, device="cpu",
                             use_device_canvas=True, batch_window_ms=5.0)
    assert core.use_device_canvas
    assert isinstance(core.batcher, tcore.RenderBatcher)
    assert isinstance(core.dev_batcher, tcore.DeviceRenderBatcher)
    assert not hasattr(tengine, "_render_stroke_jax")
    core.close()
    mock = tcore.create_core(device="cpu", use_device_canvas=True,
                             batch_window_ms=5.0)
    assert isinstance(mock.engine, tbrush.MockPaintEngine)
    assert mock.batcher is None and mock.dev_batcher is None
    assert not mock.use_device_canvas


@pytest.mark.parametrize("device_canvas,window_ms,render_thread", [
    (False, 0.0, None), (True, 0.0, "devcanvas"), (False, 5.0, None),
    (True, 5.0, "devbatch")])
def test_core_has_one_render_thread_per_path(tengine, device_canvas,
                                             window_ms, render_thread):
    """Device strokes render on one thread: the core's own for the
    unpooled device canvas, the pool batcher's worker when pooling."""
    core = tcore.create_core(paint_engine=tengine, device="cpu",
                             use_device_canvas=device_canvas,
                             batch_window_ms=window_ms)
    threads = [ex._thread_name_prefix
               for ex in (core.device_executor,
                          getattr(core.dev_batcher, "_worker", None))
               if ex is not None]
    assert threads == ([render_thread] if render_thread else [])
    core.close()


def test_on_message_counts_what_it_contains(tengine):
    async def run():
        core = tcore.create_core(paint_engine=tengine, device="cpu")
        c = _Client(core)
        await c.json(type="new_canvas", rows=8, cols=8)   # below one patch
        await c.session.on_message(b"\x00")                # truncated
        return core

    core = asyncio.run(run())
    assert core.errors == 2 and core.fallbacks == 0


# ----- RenderBatcher semantics -----

def _helper(engine):
    h = tcore.PaintingHelper(engine, style_seed=0)
    h.make_new_canvas(CANVAS, CANVAS, feature_blending=1)
    return h


def _opts(helper, x, y):
    o = helper.default_brush_options()
    o.set_position(x, y)
    return o


def _manual(batcher):
    batcher.start = lambda: None   # flushes driven by the test
    return batcher


def test_same_session_burst_matches_serial(tengine):
    hs = _helper(tengine)
    serial = [hs.render_stroke(bar_patch(i), None, _opts(hs, x, y),
                               meta={"x": x, "y": y})
              for i, (x, y) in enumerate(STROKES[:2])]
    hb = _helper(tengine)
    b = _manual(tcore.RenderBatcher(tengine, 1000.0))
    got = []
    for i, (x, y) in enumerate(STROKES[:2]):
        b.submit(hb, _opts(hb, x, y), bar_patch(i), {"x": x, "y": y},
                 lambda img, m: got.append((img, m)))
    b.flush()
    assert len(got) == 1, "the second stroke of a session must wait"
    b.flush()
    assert len(got) == 2 and not b.items and b.batch_sizes == [1, 1]
    for (img_s, _, meta_s), (img_b, meta_b) in zip(serial, got):
        assert {k: v for k, v in meta_b.items()
                if not k.startswith("_")} == meta_s
        u8_close(img_s, img_b)


def test_flush_survives_a_batch_failure(tengine, monkeypatch):
    b = _manual(tcore.RenderBatcher(tengine, 1000.0))
    got = []
    for _ in range(2):
        h = _helper(tengine)
        b.submit(h, _opts(h, 16, 16), bar_patch(0), {"x": 16, "y": 16},
                 lambda img, m: got.append((img, m)))

    def boom(*a, **kw):
        raise RuntimeError("injected batch failure")

    monkeypatch.setattr(tengine, "render_batch", boom)
    b.flush()
    assert len(got) == 2 and b.counters.fallbacks == 2
    assert b.counters.errors == 0
    for img, meta in got:
        assert img.shape == (PW, PW, 4)
        assert (meta["x"], meta["y"]) == (16, 16)


def test_one_bad_respond_drops_no_other_reply(tengine):
    b = _manual(tcore.RenderBatcher(tengine, 1000.0))
    got = []

    def bad(img, m):
        raise RuntimeError("client went away")

    h1, h2 = _helper(tengine), _helper(tengine)
    b.submit(h1, _opts(h1, 16, 16), bar_patch(0), {"x": 16, "y": 16}, bad)
    b.submit(h2, _opts(h2, 16, 16), bar_patch(0), {"x": 16, "y": 16},
             lambda img, m: got.append(img))
    b.flush()
    assert len(got) == 1 and got[0].shape == (PW, PW, 4)
    assert b.batch_sizes == [2] and b.counters.errors == 1


# ----- the pool and its batcher -----

def _pool_requests(engine, n, k):
    reqs = []
    for i in range(n):
        o = tbrush.GanBrushOptions(
            primary_color=np.array([200, 30, 30], np.uint8) if i % 2
            else None)
        o.set_style(engine.random_style(i), i)
        x, y = STROKES[(k + i) % 3]
        reqs.append({"geom": np.ascontiguousarray(
            bar_patch(10 * k + i)[:, :, -1]).ravel(), "x": x + 2 * i,
            "y": y, "opts": o})
    return reqs


def test_pool_rows_equal_serial_sessions_past_capacity(tengine):
    """Three sessions on a pool of capacity 2: the third acquire doubles the
    stacked canvas (the copy keeps the first two canvases and the scratch
    slot stays last); every pooled row equals that session's
    ``DevicePaintSession`` stroke, over three overlapping rounds."""
    pool = tdev.DeviceCanvasPool(tengine, CANVAS, CANVAS,
                                 feature_blending_level=2, crop_margin=CROP,
                                 capacity=2)
    sessions = [tdev.DevicePaintSession(tengine, CANVAS, CANVAS,
                                        feature_blending_level=2,
                                        crop_margin=CROP) for _ in range(3)]
    slots = [pool.acquire(), pool.acquire()]
    assert pool.state.features.shape[0] == 3 and pool.scratch_slot == 2
    for k in range(3):
        if k == 1:
            before = pool.state.features[:2].clone()
            slots.append(pool.acquire())
            assert pool.state.features.shape[0] == 5
            assert pool.scratch_slot == 4 and slots == [0, 1, 2]
            assert torch.equal(pool.state.features[:2], before)
            assert pool.state.mask[2].sum() == 0
        reqs = _pool_requests(tengine, len(slots), k)
        for r, s in zip(reqs, slots):
            r["slot"] = s
        rgba, metas = pool.render_batch(reqs)
        for i, r in enumerate(reqs):
            patch = np.zeros((PW, PW, 4), np.uint8)
            patch[..., 3] = r["geom"].reshape(PW, PW)
            want, meta = sessions[i].render_stroke(patch, r["opts"], r["x"],
                                                   r["y"])
            got = rgba[i].numpy()[CROP:-CROP, CROP:-CROP]
            assert metas[i] == meta
            u8_close(got, want)
            torch.testing.assert_close(
                pool.state.features[slots[i]],
                sessions[i].canvas.features[0], rtol=0, atol=1e-5)
            assert torch.equal(pool.state.mask[slots[i]],
                               sessions[i].canvas.mask)


async def _pool_run(engine, n_sessions, rounds, patch_batcher=None):
    """``n_sessions`` pooled sessions, one stroke each per round; returns
    (clients, core)."""
    core = tcore.create_core(paint_engine=engine, device="cpu",
                             use_device_canvas=True, batch_window_ms=5.0)
    if patch_batcher is not None:
        patch_batcher(core.dev_batcher)
    clients = [await _configured(core, 3 + i, timing=True)
               for i in range(n_sessions)]
    for k in range(rounds):
        for i, c in enumerate(clients):
            x, y = STROKES[k % 3]
            await c.stroke(bar_patch(k + i), x, y, crop_margin=CROP)
        await _until(lambda: all(len(c.images()) == k + 1
                                 for c in clients))
    await _until(lambda: core.dev_batcher._inflight_jobs == 0)
    core.close()
    return clients, core


def test_pool_batcher_queue_failure_leaks_no_job(tengine):
    """A defect of the JAX pool batcher (``ADVICE.md``): ``flush`` counted a
    job in flight before queueing it, so a failed queueing left the count
    up, and two of them stopped flushing for good.  Here the requests stay
    waiting and the next flush sends them."""
    def failing_twice(batcher):
        real = batcher._worker.submit
        fails = [2]

        def submit(*a, **kw):
            if fails[0]:
                fails[0] -= 1
                raise RuntimeError("injected: worker cannot take the job")
            return real(*a, **kw)
        batcher._worker.submit = submit

    clients, core = asyncio.run(_pool_run(tengine, 2, 2, failing_twice))
    assert all(len(c.images()) == 2 for c in clients)
    assert core.errors == 0 and core.dev_batcher._inflight_jobs == 0


def test_pool_batcher_fetch_queue_failure_releases_the_job(tengine):
    def failing_once(batcher):
        real = batcher._fetcher.submit
        fails = [1]

        def submit(*a, **kw):
            if fails[0]:
                fails[0] -= 1
                raise RuntimeError("injected: fetcher cannot take the job")
            return real(*a, **kw)
        batcher._fetcher.submit = submit

    async def run():
        core = tcore.create_core(paint_engine=tengine, device="cpu",
                                 use_device_canvas=True, batch_window_ms=5.0)
        failing_once(core.dev_batcher)
        c = await _configured(core, 3)
        await c.stroke(bar_patch(0), 0, 0)
        await _until(lambda: core.errors == 1
                     and core.dev_batcher._inflight_jobs == 0)
        await c.stroke(bar_patch(1), 16, 8)
        await _until(lambda: len(c.images()) == 1)
        core.close()
        return core

    core = asyncio.run(run())
    assert core.dev_batcher._inflight_jobs == 0


def test_pool_render_ms_ends_with_the_render(tengine, monkeypatch):
    """Another defect of the JAX pool batcher (``ADVICE.md``): it stamped
    the end of ``render_ms`` after the fetch queue and the copy back.  A
    copy held up by 0.3 s must not show in ``render_ms``, only in
    ``server_ms``."""
    real = tcore._Readback.wait_copied

    def slow(self):
        time.sleep(0.3)
        return real(self)

    monkeypatch.setattr(tcore._Readback, "wait_copied", slow)
    clients, core = asyncio.run(_pool_run(tengine, 1, 2))
    for d in clients[0].timings():
        assert d["path"] == "device_batched"
        assert d["render_ms"] < 250 <= d["server_ms"], d
    assert core.errors == 0


def test_pool_batcher_replies_in_order_and_releases_slots(tengine):
    clients, core = asyncio.run(_pool_run(tengine, 3, 3))
    assert core.fallbacks == 0 and core.errors == 0
    assert max(core.dev_batcher.batch_sizes) > 1
    for c in clients:
        assert [m for m in (i[1] for i in c.images())] == \
            [{"x": x + CROP, "y": y + CROP} for x, y in STROKES]
    pool = next(iter(core.dev_batcher.pools.values()))
    assert len(pool._free) == pool._capacity - 3
    for c in clients:
        c.session.on_close()
    assert len(pool._free) == pool._capacity


# ----- the import boundary -----

def test_serving_modules_import_without_tornado_and_pil():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('tornado', 'PIL', 'jax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import brushstroke_engine_torch.ui.core\n"
        "import brushstroke_engine_torch.ui.protocol\n"
        "import brushstroke_engine_torch.tools.bench_serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tornado', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ----- save_native -----

def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)]


def test_save_native_round_trips_a_jax_bundle(files, tmp_path):
    """A JAX-written f32 bundle, loaded and saved again by the port, is the
    same bundle leaf by leaf: keys, shapes, dtypes and values."""
    bundle = tckpt.load_native(files["bundle"], device="cpu")
    out = str(tmp_path / "again.pkl")
    tckpt.save_native(out, bundle)
    with open(files["bundle"], "rb") as f:
        want = pickle.load(f)
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith(("_params", "_state")):
            gl, wl = _leaves(got[k]), _leaves(v)
            assert [p for p, _ in gl] == [p for p, _ in wl]
            for (p, g), (_, w) in zip(gl, wl):
                assert g.dtype == w.dtype and g.shape == w.shape, p
                np.testing.assert_array_equal(g, w, err_msg=p)
        else:
            assert got[k] == v, k


def test_save_native_bundle_renders_the_same_in_both_packages(tmp_path):
    """A bundle the port writes (its own random init) loads in the JAX
    package and renders the same RGBA through both packages."""
    model = small_model(seed=9)
    tgen, tenc = model["cfg"]
    bundle = tckpt.EngineBundle(tgen, *(model["torch"][k] for k in (
        "gen_params", "gen_state")), tenc, *(model["torch"][k] for k in (
            "enc_params", "enc_state")), geom_inject_resolutions=(0, 1),
        extra={"note": "port"})
    path = str(tmp_path / "port.pkl")
    tckpt.save_native(path, bundle)
    jb = jckpt.load_native(path)
    assert jb.gen_cfg == model["jax_cfg"][0] and jb.enc_cfg == \
        model["jax_cfg"][1]
    assert jb.extra == {"note": "port"} and jb.geom_inject_resolutions == \
        (0, 1)
    for k, v in model["np"].items():
        if k == "gen_params" or k.startswith("enc") or k == "gen_state":
            gl, wl = _leaves(getattr(jb, k)), _leaves(v)
            assert [p for p, _ in gl] == [p for p, _ in wl]
            for (p, g), (_, w) in zip(gl, wl):
                assert g.dtype == np.asarray(w).dtype and g.shape == \
                    np.shape(w), p
    patch = bar_patch(3)
    rgba = []
    for pkg, eng in ((jbrush, jbrush.PaintEngineFactory.create(path)),
                     (tbrush, tbrush.PaintEngineFactory.create(
                         path, device="cpu"))):
        opts = pkg.GanBrushOptions()
        opts.set_style(eng.random_style(1))
        opts.set_position(8, 4)
        rgba.append(np.asarray(
            eng._run_core(eng.prepare_geom_input(patch), opts)["rgba"]))
    np.testing.assert_allclose(rgba[1], rgba[0], rtol=0, atol=1e-5)


# ----- repairs: draw_stroke_into, the icon cache, the launch counters -----

@pytest.mark.parametrize("case", ["dot", "dot_at_edge", "spline",
                                  "spline_to_edge", "spline_leaving"])
def test_draw_stroke_into_equals_draw_stroke(case):
    """Tolerance 1e-6: both evaluate the same f64 distances and round once
    to f32; the box of ``draw_stroke_into`` only skips pixels that are
    background for a segment."""
    rng = np.random.default_rng(["dot", "dot_at_edge", "spline",
                                 "spline_to_edge", "spline_leaving"]
                                .index(case))
    w = 48
    if case == "dot":
        pts = rng.uniform(8, 40, size=(1, 2))
    elif case == "dot_at_edge":
        pts = np.array([[0.0, rng.uniform(0, w)]])
    else:
        pts = curves.random_spline_points(rng, w, margin=0.1)
        if case == "spline_to_edge":
            pts = pts + (w * 0.9 - pts.max(axis=0))
        elif case == "spline_leaving":      # centred on the right edge
            pts = pts - pts.mean(axis=0) + np.array([w / 2, w - 1.0])
    radius = float(rng.uniform(1.5, 6.0))
    want = curves.draw_stroke(w, pts, radius)
    got = np.ones((w, w), np.float32)
    curves.draw_stroke_into(got, pts, radius)
    assert want.min() < 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_icon_cache_moves_a_corrupt_file_aside(tmp_path):
    path = tmp_path / "lib.txt.icons.zip"
    path.write_bytes(b"not a zip: the user's file")
    (tmp_path / "lib.txt.icons.zip.corrupt").write_bytes(b"older")
    store = tlib.IconStore(str(path))
    aside = tmp_path / "lib.txt.icons.zip.corrupt.1"
    assert aside.read_bytes() == b"not a zip: the user's file"
    assert (tmp_path / "lib.txt.icons.zip.corrupt").read_bytes() == b"older"
    icon = np.full((8, 8, 3), 120, np.uint8)
    store.put("5", icon)
    assert np.abs(store.get("5").astype(int) - 120).max() <= 8   # JPEG
    store.close()
    assert zipfile.is_zipfile(path)


def test_icon_cache_that_cannot_move_the_file_raises(tmp_path, monkeypatch):
    path = tmp_path / "x.icons.zip"
    path.write_bytes(b"junk")

    def refuse(src, dst):
        raise PermissionError("read-only directory")

    monkeypatch.setattr(tlib.os, "rename", refuse)
    with pytest.raises(OSError, match="moved aside"):
        tlib.IconStore(str(path))
    assert path.read_bytes() == b"junk"


@pytest.mark.parametrize("kind", ["directory", "dangling_link"])
def test_icon_cache_on_no_regular_file_raises_and_moves_nothing(tmp_path,
                                                                kind):
    path = tmp_path / "lib.txt.icons.zip"
    if kind == "directory":
        path.mkdir()
        (path / "painting.png").write_bytes(b"the user's file")
    else:
        path.symlink_to(tmp_path / "missing")
    with pytest.raises(OSError, match="no regular file"):
        tlib.IconStore(str(path))
    assert os.listdir(tmp_path) == ["lib.txt.icons.zip"]
    if kind == "directory":
        assert (path / "painting.png").read_bytes() == b"the user's file"
    else:
        assert path.is_symlink()


class _Stream:
    cuda_stream = 0


class _SlowCount:
    """A stand-in for a kernel wrapper's ``launches`` whose read gives the
    interpreter away, as a thread switch between an unlocked ``+=``'s read
    and write would: an unlocked increment loses counts here."""

    def __init__(self):
        self._n = 0
        self.shapes = set()

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, v):
        self._n = v


def _hammer(launch, threads=16, each=100):
    """``threads`` (more than the cores) x ``each`` launches with a short
    switch interval; returns the count they make."""
    def work():
        for _ in range(each):
            launch()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    return threads * each


def test_fir_launch_count_is_exact_under_threads(monkeypatch):
    """The counting path of ``_launch_kernel`` run on the CPU with the
    kernel's entry point stubbed (the launch itself needs the card)."""
    counter = _SlowCount()
    monkeypatch.setattr(fe, "fir4_epilogue", counter)
    monkeypatch.setattr(fe, "_kernel_fns",
                        lambda: (lambda *a: 0, lambda rc: b""))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    x = torch.zeros((1, 5, 5, 4))
    taps = fe.correlation_taps(setup_filter([1, 3, 3, 1]))
    args = (x, taps, torch.ones((1, 4)), None, torch.zeros(4), 1.0, None,
            0.2, torch.float32)
    n = _hammer(lambda: fe._launch_kernel(*args))
    assert counter.launches == n
    assert counter.shapes == {(1, 2, 2, 4, "torch.float32")}


@pytest.mark.parametrize("transposed", [False, True])
def test_warp_launch_count_is_exact_under_threads(monkeypatch, transposed):
    counter = _SlowCount()
    monkeypatch.setattr(tw, "warp_twopass_t" if transposed
                        else "warp_twopass", counter)
    monkeypatch.setattr(tw, "_kernel_fns", lambda: (
        lambda *a: 0, lambda *a: 0, None, lambda rc: b""))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    imgs = torch.zeros((1, 4, 4, 3))
    sc = torch.zeros((1, 8))
    n = _hammer(lambda: tw._launch(imgs, sc, transposed))
    assert counter.launches == n


def test_count_launch_is_atomic():
    counter = _SlowCount()
    n = _hammer(lambda: cuda_build.count_launch(counter))
    assert counter.launches == n
