"""Serving core of the drawing server: sessions, the two cross-session
batchers and the engine set-up, with no transport.

Counterpart of ``brushstroke_engine_tpu/ui/server.py`` without tornado.  A
:class:`PaintSession` takes what a websocket delivers (``bytes``: a render
request; ``str``: a JSON control message) and replies through its ``send``
callback with ``bytes`` (binary) or a ``dict`` (JSON).  Scheduling is the
running ``asyncio`` loop's, which tornado >= 5 runs on, so the tornado shell
(``ui/server.py``), ``chip_smoke.py`` and ``tools/bench_serve.py`` drive the
same code.  Imports neither tornado nor PIL.

A full-patch stroke takes one of four image paths, as in the JAX server:

  * helper: ``PaintingHelper.render_stroke`` on the loop thread;
  * device canvas: ``DevicePaintSession.render_stroke`` on the core's
    render thread, so the loop serves other sessions meanwhile;
  * batched: :class:`RenderBatcher`, one generator pass per flush window
    for one stroke of every waiting session;
  * pooled: :class:`DeviceRenderBatcher`, the same over the sessions'
    canvases stacked in a ``DeviceCanvasPool``, rendered on a worker thread.

A painter should not lose the session to one bad stroke, so failures are
contained as in the JAX server -- a failed batch falls back to the
per-request path, a failed pooled group is dropped, a message that raises is
logged -- but each one is counted in :class:`ServeCounters` (``fallbacks``,
``errors``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import os
import re
import tempfile
import threading
import time

import numpy as np
import torch

from brushstroke_engine_torch.engine.brush import (
    GanBrushOptions, PaintEngineFactory,
)
from brushstroke_engine_torch.engine.canvas import PaintingHelper
from brushstroke_engine_torch.engine.device_canvas import (
    DeviceCanvasPool, DevicePaintSession,
)
from brushstroke_engine_torch.engine.library import BrushLibrary
from brushstroke_engine_torch.ui import protocol
from brushstroke_engine_torch.utils.util import resolve_device

logger = logging.getLogger(__name__)

# Sessions a new pool holds before its stacked canvas first doubles.
POOL_CAPACITY = 8
# Pooled jobs between dispatch and reply: one renders while the one before
# copies back; strokes that arrive meanwhile wait for the next flush.
PIPELINE_DEPTH = 2
# What a server warms before it listens: the unblended and the client's
# default blend level, and the batch sizes of a cross-session flush.
WARM_BLEND_LEVELS = (0, 2)
WARM_BATCHES = (1, 2, 4, 8)


def generate_z_file(gan_checkpoint):
    if gan_checkpoint is None:
        return os.path.join(tempfile.gettempdir(), "brushstroke_saved_zs.txt")
    return gan_checkpoint + ".saved_zs.txt"


def parse_libraries(libraries_arg):
    """'name:mode:path,...' spec parser (reference run.py:145-156)."""
    libraries = []
    if libraries_arg:
        libraries = [x.split(":") for x in libraries_arg.split(",")]
    for i in range(len(libraries)):
        if len(libraries[i]) == 1:
            libraries[i] = [os.path.basename(libraries[i][0]), "disp",
                            libraries[i][0]]
        elif len(libraries[i]) == 2:
            libraries[i] = [libraries[i][0], "disp", libraries[i][1]]
        if len(libraries[i]) != 3 or not (
                libraries[i][1] in ("disp", "random")
                or re.match(r"rand\d+", libraries[i][1])):
            raise ValueError(f"Malformed library spec {libraries[i]}")
    return libraries


class ServeCounters:
    """What the core contained instead of failing: ``fallbacks`` (requests
    re-rendered one by one after their batch failed) and ``errors``
    (messages that raised, replies dropped).  Bumped from worker threads
    too, so under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fallbacks = 0
        self.errors = 0

    def add(self, name: str, n: int = 1):
        with self._lock:
            setattr(self, name, getattr(self, name) + n)


def _image_reply(extra, img, meta_out) -> bytes:
    return protocol.int32_to_binary(extra) + protocol.image_patch_to_binary(
        img, meta_out["x"], meta_out["y"])


class PaintSession:
    """One connection's painting session (the body of the JAX server's
    ``DrawingWebSocketHandler``, reference util.py:107-245).

    ``send(msg)`` delivers a reply: ``bytes`` for a binary message, a
    ``dict`` for a JSON one.  Messages of one session must be handled in
    order, each ``on_message`` awaited before the next starts, as tornado
    does for a websocket.
    """

    def __init__(self, core: "ServingCore", send):
        self.core = core
        self.send = send
        self.helper = PaintingHelper(core.engine, style_seed=core.style_seed,
                                     debug_dir=core.debug_dir)
        self.use_positions = False
        self.uvs_mapping = False
        # Pooled path: the session's canvas is a slot of a pool.
        self.dev_pool = None
        self.dev_slot = None
        # Device-canvas path: made per new_canvas, at the first stroke.
        self.dev_session = None
        self._canvas_shape = None
        self._blend_level = 0
        # Timing side channel (opt-in, set_option timing=1): after each
        # binary render reply a JSON {"type": "timing"} message with the
        # stroke's queue wait, render time and total server time.
        self.collect_timing = False
        self._stroke_seq = 0

    def open(self):
        self.send({"type": "modelinfo",
                   "data": {"patch_width": self.helper.engine.patch_width}})
        self.send_current_brush_info()

    def send_current_brush_info(self):
        opts = self.helper.brush_options
        colors = ""
        mapper = getattr(self.helper.engine, "uvs_mapper", None)
        if mapper is not None:
            try:
                colors = mapper.get_colors(opts)
            except Exception as e:
                self.core.counters.add("errors")
                logger.warning(f"color info failed: {e}")
        self.send({"type": "brushinfo",
                   "data": {"style_id": str(opts.style_id),
                            "library_id": str(opts.library_id),
                            "colors": colors}})

    def save_current_brush(self):
        opts = self.helper.brush_options
        zs_file = self.core.saved_zs_filename
        if zs_file is None or opts.style_id is None or opts.style_z is None:
            return
        try:
            with open(zs_file, "a") as f:
                f.write(("%d " % int(opts.style_id)) + " ".join(
                    "%f" % x for x in np.asarray(opts.style_z)[0].tolist())
                    + "\n")
        except (RuntimeError, ValueError):
            logger.warning("Failed to save z")

    async def on_message(self, message):
        try:
            if isinstance(message, (bytes, bytearray, memoryview)):
                await self._handle_binary_request(bytes(message))
            else:
                self._handle_json_request(message)
        except Exception as e:
            self.core.counters.add("errors")
            logger.exception(f"Failed to handle incoming message: {e}")

    async def _handle_binary_request(self, raw):
        t_recv = time.perf_counter()
        meta, offset = protocol.decode_render_request_metadata(raw)
        patch_meta, img_stroke, img_canvas = \
            protocol.binary_to_image_patches(raw, offset)
        meta.update(patch_meta)
        await self._handle_image_request(meta, img_stroke, img_canvas,
                                         t_recv=t_recv)

    def _send_timing(self, t_recv, t_start, t_end, path):
        """JSON timing message for the stroke just answered (opt-in)."""
        if not self.collect_timing or t_recv is None:
            return
        seq = self._stroke_seq
        self._stroke_seq += 1
        now = time.perf_counter()
        self.send({"type": "timing", "data": {
            "seq": seq,
            "queue_ms": round((t_start - t_recv) * 1e3, 3),
            "render_ms": round((t_end - t_start) * 1e3, 3),
            "server_ms": round((now - t_recv) * 1e3, 3),
            "path": path}})

    def _batched_respond(self, extra, t_recv, path):
        """The reply callback of a batcher: the image, then the timing of
        the dispatch window the batcher stamped into the out meta."""
        def respond(img, meta_out):
            self.send(_image_reply(extra, img, meta_out))
            self._send_timing(t_recv, meta_out["_t_start"],
                              meta_out["_t_end"], path)
        return respond

    async def _handle_image_request(self, meta, bg_img, fg_img,
                                    t_recv=None):
        opts = self.helper.default_brush_options()
        for colorinfo in meta["colors"]:
            opts.set_color(int(colorinfo[0]), np.asarray(colorinfo[1:],
                                                         np.uint8))
        opts.debug = meta["debug"]
        if self.use_positions:
            opts.set_position(int(meta["x"]), int(meta["y"]))
        else:
            opts.position = None
        opts.enable_uvs_mapping = self.uvs_mapping
        extra = meta["extra_data"] or 0
        core = self.core
        engine = self.helper.engine

        pw = engine.patch_width
        is_full_patch = bg_img.shape[0] == pw and bg_img.shape[1] == pw
        if core.use_device_canvas and self._blend_level > 0 and \
                self.use_positions and is_full_patch:
            if core.dev_batcher is not None and self._canvas_shape:
                # Pooled: the stroke joins the next cross-session flush.
                if self.dev_slot is None:
                    self.dev_pool = core.dev_batcher.pool_for(
                        self._canvas_shape, self._blend_level,
                        int(meta.get("crop_margin", 0)))
                    self.dev_slot = core.dev_batcher.acquire_slot(
                        self.dev_pool)
                # The wire's raw uint8 alpha: the inversion to geometry
                # runs on the device, so one byte per pixel crosses.
                geom = np.ascontiguousarray(bg_img[:, :, -1]).ravel()
                core.dev_batcher.submit(
                    self, self.dev_pool, self.dev_slot, geom, opts,
                    int(meta["x"]), int(meta["y"]),
                    self._batched_respond(extra, t_recv, "device_batched"))
                return
            if self.dev_session is None and self._canvas_shape:
                self.dev_session = DevicePaintSession(
                    engine, self._canvas_shape[0], self._canvas_shape[1],
                    feature_blending_level=self._blend_level,
                    crop_margin=int(meta.get("crop_margin", 0)))
            if self.dev_session is not None:
                # The whole stroke on the core's render thread: the loop
                # serves other sessions meanwhile.  This session's strokes
                # stay in order because its messages are handled one at a
                # time.
                session = self.dev_session

                def timed_render(_x=int(meta["x"]), _y=int(meta["y"])):
                    t0 = time.perf_counter()
                    out = session.render_stroke(bg_img, opts, _x, _y)
                    return out, t0, time.perf_counter()

                (res_img, meta_out), t0, t1 = \
                    await asyncio.get_running_loop().run_in_executor(
                        core.device_executor, timed_render)
                self.send(_image_reply(extra, res_img, meta_out))
                self._send_timing(t_recv, t0, t1, "device_canvas")
                return

        if core.batcher is not None and is_full_patch \
                and not meta["debug"] and not self.uvs_mapping \
                and engine.supports_device_render \
                and not opts.custom_args.get("noise_buffers"):
            core.batcher.submit(self.helper, opts, bg_img, meta,
                                self._batched_respond(extra, t_recv,
                                                      "batched"))
            return

        t0 = time.perf_counter()
        res_img, debug_img, meta_out = self.helper.render_stroke(
            bg_img, fg_img, opts, meta)
        t1 = time.perf_counter()
        self.send(_image_reply(extra, res_img, meta_out))
        self._send_timing(t_recv, t0, t1, "helper")
        if debug_img is not None:
            self.send(_image_reply(1, debug_img, {"x": 0, "y": 0}))

    def _handle_json_request(self, raw):
        msg = json.loads(raw)
        mtype = msg.get("type")
        if mtype == "set_brush":
            if msg.get("style_id") and msg.get("library_id"):
                lib_id = msg.get("library_id")
                style_id = msg.get("style_id")
                style_id2 = msg.get("style_id2")
                libraries = self.core.libraries
                if lib_id in libraries and \
                        style_id in libraries[lib_id].get_style_ids():
                    lib = libraries[lib_id]
                    if style_id2 and style_id2 in lib.get_style_ids():
                        lib.set_interpolated_style(
                            style_id, style_id2,
                            float(msg.get("alpha", 0.5)),
                            self.helper.brush_options)
                    else:
                        lib.set_style(style_id, self.helper.brush_options)
                    self.helper.brush_options.library_id = lib_id
            else:
                self.helper.set_new_brush(msg.get("seed"))
            self.send_current_brush_info()
        elif mtype == "save_brush":
            self.save_current_brush()
        elif mtype == "set_option":
            if msg.get("option") == "positions":
                self.use_positions = bool(msg.get("value"))
            elif msg.get("option") == "uvs_mapping":
                self.uvs_mapping = bool(msg.get("value"))
            elif msg.get("option") == "timing":
                self.collect_timing = bool(msg.get("value"))
        elif mtype == "set_render_mode":
            self.helper.set_render_mode(msg.get("mode"))
        elif mtype == "new_canvas":
            self.helper.make_new_canvas(
                int(msg.get("rows")), int(msg.get("cols")),
                feature_blending=int(msg.get("feature_blending", 0)))
            self._canvas_shape = (int(msg.get("rows")),
                                  int(msg.get("cols")))
            self._blend_level = int(msg.get("feature_blending", 0))
            self.dev_session = None
            self._release_dev_slot()
        else:
            logger.warning(f"Unknown json message type {mtype}")

    def _release_dev_slot(self):
        if self.dev_slot is not None:
            self.core.dev_batcher.release_slot(self.dev_pool, self.dev_slot)
            self.dev_pool = None
            self.dev_slot = None

    def on_close(self):
        self._release_dev_slot()
        logger.info("Session closed.")


class _WindowBatcher:
    """Queue plus flush window on the running loop: the first request after
    a flush arms a flush ``window_ms`` later, which re-arms itself while
    requests remain."""

    def __init__(self, engine, window_ms: float, counters=None):
        self.engine = engine
        self.window_ms = window_ms
        self.counters = counters if counters is not None else ServeCounters()
        self.items = []
        # Real rows of each generator pass, in dispatch order.
        self.batch_sizes = []
        self._handle = None

    def start(self):
        if self._handle is None:
            self._handle = asyncio.get_running_loop().call_later(
                self.window_ms / 1e3, self._tick)

    def _tick(self):
        self._handle = None
        try:
            self.flush()
        finally:
            if self.items:
                self.start()

    def flush(self):
        raise NotImplementedError

    @staticmethod
    def _one_per_session(items, key):
        """At most one request per session this flush; the rest stay queued
        in order, so each sees its predecessor's feature write-back."""
        taken, deferred, seen = [], [], set()
        for it in items:
            k = key(it)
            (deferred if k in seen else taken).append(it)
            seen.add(k)
        return taken, deferred


class RenderBatcher(_WindowBatcher):
    """Cross-session micro-batching of helper strokes: one generator pass per
    flush window for one request of every waiting session (the JAX server's
    ``RenderBatcher``).  Requests that cannot batch (debug sheets,
    stored-noise brushes, UVS mapping, partial patches) keep the per-request
    path."""

    def submit(self, helper, opts, stroke_patch, meta, respond):
        """Queue one request; ``respond(img, out_meta)`` is called from the
        flush with the rendered uint8 patch.  ``prepare_render`` (which
        gathers the stored features) waits for the flush, so overlapping
        strokes of one session blend as on the serial path."""
        self.items.append({"helper": helper, "opts": opts,
                           "patch": stroke_patch, "meta": meta,
                           "respond": respond})
        self.start()

    @staticmethod
    def _group_key(item):
        opts = item["opts"]
        rf = item["prep"]["generator_kwargs"].get("return_features", ())
        return (rf, opts.style_ws is not None,
                opts.get_position() is not None)

    def _respond_single(self, it):
        """The per-request path, for a request whose batch failed."""
        self.counters.add("fallbacks")
        try:
            t0 = time.perf_counter()
            img, _debug, out_meta = it["helper"].render_stroke(
                it["patch"], None, it["opts"], it["meta"])
            out_meta["_t_start"] = t0
            out_meta["_t_end"] = time.perf_counter()
            it["respond"](img, out_meta)
        except Exception:
            self.counters.add("errors")
            logger.exception("RenderBatcher: per-request fallback failed; "
                             "dropping one response")

    def _blended_rows(self, rf, rows):
        """``{res: (features [B,R,R,C], alpha [B,R,R,1])}`` over the rows;
        a row with nothing stored gets zero features and zero alpha, made
        on the engine's device in the stored features' dtype."""
        if not rf:
            return None
        res = rf[0]
        bfs = [it["prep"]["generator_kwargs"]["blended_features"].get(res)
               for it in rows]
        stored = next((b for b in bfs if b is not None), None)
        r = stored[0].shape[1] if stored is not None else res
        dtype = stored[0].dtype if stored is not None else torch.float32
        dev = self.engine.device
        ch = self.engine.gen_cfg.synthesis.channels(res)
        zf = torch.zeros((1, r, r, ch), dtype=dtype, device=dev)
        za = torch.zeros((1, r, r, 1), dtype=torch.float32, device=dev)
        feats = torch.cat([b[0] if b is not None else zf for b in bfs])
        alphas = torch.cat([b[1] if b is not None else za for b in bfs])
        return {res: (feats, alphas)}

    def flush(self):
        if not self.items:
            return
        taken, self.items = self._one_per_session(self.items,
                                                  lambda it: id(it["helper"]))
        items = []
        for it in taken:
            try:
                it["prep"] = it["helper"].prepare_render(it["patch"],
                                                         it["meta"])
                items.append(it)
            except Exception:
                logger.exception("RenderBatcher: prepare_render failed; "
                                 "falling back to the per-request path")
                self._respond_single(it)
        groups = {}
        for it in items:
            groups.setdefault(self._group_key(it), []).append(it)

        for (rf, _use_ws, _has_pos), group in groups.items():
            try:
                t0 = time.perf_counter()
                geoms = np.concatenate([it["prep"]["geom"] for it in group])
                out = self.engine.render_batch(
                    geoms, [it["opts"] for it in group],
                    blended_features=self._blended_rows(rf, group),
                    return_features=rf)
            except Exception:
                logger.exception("RenderBatcher: batched dispatch failed; "
                                 "falling back to the per-request path")
                for it in group:
                    self._respond_single(it)
                continue
            self.batch_sizes.append(len(group))
            for i, it in enumerate(group):
                try:
                    raw_row = {f"features{r}": out[f"features{r}"][i:i + 1]
                               for r in rf}
                    img, out_meta = it["helper"].finish_render(
                        it["prep"], out["rgba"][i], raw_row)
                    out_meta["_t_start"] = t0
                    out_meta["_t_end"] = time.perf_counter()
                    it["respond"](img, out_meta)
                except Exception:
                    self.counters.add("errors")
                    logger.exception("RenderBatcher: finishing one request "
                                     "failed; its response is dropped")


class _Readback:
    """The copy of one pooled dispatch's uint8 RGBA to the host.

    On CUDA the worker records ``rendered`` after the render on its current
    stream, then copies with ``non_blocking=True`` into pinned memory on a
    side stream that waits on that event, and records ``copied`` there: the
    fetcher of job k waits on these two events, not behind job k+1's
    kernels, which the worker queues on the render stream meanwhile.  On the
    CPU the render is complete when the call returns.
    """

    def __init__(self, rgba, copy_stream=None):
        if not rgba.is_cuda:
            self.rendered = None
            self.t_rendered = time.perf_counter()
            self.host = rgba
            return
        self.rendered = torch.cuda.Event()
        self.rendered.record(torch.cuda.current_stream(rgba.device))
        copy_stream.wait_event(self.rendered)
        with torch.cuda.stream(copy_stream):
            self.host = torch.empty(rgba.shape, dtype=rgba.dtype,
                                    pin_memory=True)
            self.host.copy_(rgba, non_blocking=True)
            rgba.record_stream(copy_stream)
            self.copied = torch.cuda.Event()
            self.copied.record(copy_stream)

    def wait_rendered(self) -> float:
        """Host clock when the render was seen complete."""
        if self.rendered is None:
            return self.t_rendered
        self.rendered.synchronize()
        return time.perf_counter()

    def wait_copied(self) -> np.ndarray:
        if self.rendered is not None:
            self.copied.synchronize()
        return self.host.numpy()


def _log_failure(future):
    """Done-callback of the pooled batcher's jobs: what their own handlers
    did not catch is logged, not lost in the future."""
    if not future.cancelled() and future.exception() is not None:
        logger.error("DeviceRenderBatcher: job failed",
                     exc_info=future.exception())


class DeviceRenderBatcher(_WindowBatcher):
    """Cross-session micro-batching of device-canvas strokes: every waiting
    session's next stroke in one :func:`render_strokes_pool` pass over the
    stacked canvases of a :class:`DeviceCanvasPool` (the JAX server's
    ``DeviceRenderBatcher``).

    At most one request per session per flush; all renders run FIFO on one
    worker thread and all copies back on one fetcher thread, so each
    session's replies arrive in stroke order.  At most ``PIPELINE_DEPTH``
    jobs are between dispatch and reply: strokes that arrive meanwhile
    accumulate, so the next flush takes them all in one pass.
    """

    def __init__(self, engine, window_ms: float, counters=None):
        super().__init__(engine, window_ms, counters)
        self.pools = {}
        self._worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="devbatch")
        self._fetcher = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="devfetch")
        self._inflight_jobs = 0
        # Guards the pools' state (slot acquire / release / reset on the
        # loop thread) against the worker's render.
        self._state_lock = threading.Lock()
        self._copy_stream = None

    def pool_for(self, canvas_shape, level, crop_margin):
        key = (tuple(canvas_shape), int(level), int(crop_margin))
        if key not in self.pools:
            with self._state_lock:
                self.pools[key] = DeviceCanvasPool(
                    self.engine, canvas_shape[0], canvas_shape[1],
                    feature_blending_level=level, crop_margin=crop_margin,
                    capacity=POOL_CAPACITY)
        return self.pools[key]

    def acquire_slot(self, pool):
        with self._state_lock:
            return pool.acquire()

    def release_slot(self, pool, slot):
        with self._state_lock:
            pool.release(slot)

    def submit(self, session, pool, slot, geom, opts, x, y, respond):
        self.items.append({"session": session, "pool": pool, "slot": slot,
                           "geom": geom, "opts": opts, "x": x, "y": y,
                           "respond": respond})
        self.start()

    def flush(self):
        if not self.items or self._inflight_jobs >= PIPELINE_DEPTH:
            return
        taken, deferred = self._one_per_session(
            self.items, lambda it: id(it["session"]))
        groups = {}
        for it in taken:
            key = (id(it["pool"]), it["opts"].style_ws is not None)
            groups.setdefault(key, []).append(it)
        loop = asyncio.get_running_loop()
        try:
            fut = self._worker.submit(self._run_groups,
                                      list(groups.values()), loop)
        except Exception:
            # Nothing was queued: the requests stay waiting and the
            # in-flight count is untouched, so flushing goes on.
            logger.exception("DeviceRenderBatcher: cannot queue the job")
            return
        fut.add_done_callback(_log_failure)
        self.items = deferred
        self._inflight_jobs += 1

    def _job_done(self):
        # Loop thread: strokes that arrived during the render should not
        # also wait out a window.
        self._inflight_jobs -= 1
        self.flush()

    def _side_stream(self, device):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        return self._copy_stream

    def _run_groups(self, groups, loop):
        """Worker thread: dispatch each group's render and its copy back,
        then hand the waiting to the fetcher, so the next job's dispatch
        overlaps this one's render and copy."""
        dispatched = []
        try:
            for group in groups:
                pool = group[0]["pool"]
                t0 = time.perf_counter()
                try:
                    with self._state_lock:
                        rgba, metas = pool.render_batch(
                            [{"slot": it["slot"], "geom": it["geom"],
                              "x": it["x"], "y": it["y"],
                              "opts": it["opts"]} for it in group])
                        job = _Readback(rgba, self._side_stream(rgba.device)
                                        if rgba.is_cuda else None)
                except Exception:
                    self.counters.add("errors", len(group))
                    logger.exception(
                        "DeviceRenderBatcher: batched dispatch failed; "
                        f"dropping {len(group)} response(s)")
                    continue
                self.batch_sizes.append(len(group))
                dispatched.append((pool, group, job, metas, t0))
            self._fetcher.submit(self._fetch_job, dispatched, loop) \
                .add_done_callback(_log_failure)
        except Exception:
            self.counters.add("errors",
                              sum(len(d[1]) for d in dispatched))
            logger.exception("DeviceRenderBatcher: cannot queue the fetch")
            loop.call_soon_threadsafe(self._job_done)

    def _respond(self, respond, img, meta):
        try:
            respond(img, meta)
        except Exception:
            self.counters.add("errors")
            logger.exception("DeviceRenderBatcher: one reply failed")

    def _fetch_job(self, dispatched, loop):
        try:
            for pool, group, job, metas, t0 in dispatched:
                try:
                    # render_ms ends when the render did, not after the
                    # copy or this thread's queue.
                    t1 = job.wait_rendered()
                    imgs = job.wait_copied()
                except Exception:
                    self.counters.add("errors", len(group))
                    logger.exception(
                        "DeviceRenderBatcher: batched readback failed; "
                        f"dropping {len(group)} response(s)")
                    continue
                m = pool.crop_margin
                for i, it in enumerate(group):
                    img = imgs[i]
                    if m > 0:
                        img = img[m:-m, m:-m]
                    meta = dict(metas[i], _t_start=t0, _t_end=t1)
                    loop.call_soon_threadsafe(self._respond, it["respond"],
                                              np.ascontiguousarray(img), meta)
        finally:
            loop.call_soon_threadsafe(self._job_done)

    def warmup(self, rows, cols, level, crop_margin=0):
        """Run the pooled render once per batch size of ``WARM_BATCHES`` for
        a canvas
        configuration, all rows on the scratch slot (no session's canvas is
        touched), so the first strokes pay no kernel build or cuDNN set-up."""
        pool = self.pool_for((rows, cols), level, crop_margin)
        eng = self.engine
        patch = PaintingHelper.test_stroke(eng.patch_width)
        geom = np.ascontiguousarray(patch[:, :, -1]).ravel()
        for bucket in WARM_BATCHES:
            reqs = []
            for i in range(bucket):
                o = GanBrushOptions()
                o.set_style(eng.random_style(i), i)
                reqs.append({"slot": pool.scratch_slot, "geom": geom,
                             "x": 0, "y": 0, "opts": o})
            with self._state_lock:
                rgba, _ = pool.render_batch(reqs)
            rgba.cpu()

    def close(self):
        self._worker.shutdown(wait=True)
        self._fetcher.shutdown(wait=True)


def warmup_engine(engine, batched: bool = False):
    """Run the render paths the first strokes take once, at each of
    ``WARM_BLEND_LEVELS``, so no user stroke pays the kernel build or the
    cuDNN set-up.

    ``batched``: also run ``render_batch`` at each of ``WARM_BATCHES`` for
    the common group of the cross-session batcher (positions on, stored
    features at the highest blend level).
    """
    if not engine.supports_device_render:
        return
    t0 = time.time()
    patch = PaintingHelper.test_stroke(engine.patch_width)
    for lvl in WARM_BLEND_LEVELS:
        helper = PaintingHelper(engine, style_seed=0)
        helper.make_new_canvas(engine.patch_width * 2,
                               engine.patch_width * 2,
                               feature_blending=lvl)
        opts = helper.default_brush_options()
        opts.set_position(0, 0)
        # Twice: a fresh canvas, then one with stored features to blend.
        helper.render_stroke(patch, None, opts, meta={"x": 0, "y": 0})
        helper.render_stroke(patch, None, opts, meta={"x": 0, "y": 0})
    # The brush info's color swatch, sent at every connect.
    mapper = getattr(engine, "uvs_mapper", None)
    if mapper is not None:
        mapper.get_colors(PaintingHelper(engine, style_seed=0)
                          .default_brush_options())
    if batched:
        lvl = max(WARM_BLEND_LEVELS)
        pw = engine.patch_width
        res = pw // 2 ** (lvl - 1) if lvl > 0 else None
        geom1 = engine.prepare_geom_input(patch).reshape(1, pw, pw, 1)
        ch = engine.gen_cfg.synthesis.channels(res) if res else 0
        for bucket in WARM_BATCHES:
            opts_rows = []
            for i in range(bucket):
                o = GanBrushOptions()
                o.set_style(engine.random_style(i), i)
                o.set_position(0, 0)
                opts_rows.append(o)
            blended, rf = None, ()
            if res:
                dev = engine.device
                blended = {res: (torch.zeros((bucket, res, res, ch),
                                             device=dev),
                                 torch.zeros((bucket, res, res, 1),
                                             device=dev))}
                rf = (res,)
            engine.render_batch(np.concatenate([geom1] * bucket), opts_rows,
                                blended_features=blended, return_features=rf)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    logger.info(f"Warmed render paths (blend levels {WARM_BLEND_LEVELS}, "
                f"batches {WARM_BATCHES if batched else ()}) "
                f"in {time.time() - t0:.1f}s")


class ServingCore:
    """What every session of one server shares: the engine, the brush
    libraries, the batchers (made only for an engine with a device render,
    ``supports_device_render``) and the counters."""

    def __init__(self, engine, libraries=None, library_specs=(),
                 style_seed=None, debug_dir=None, saved_zs_filename=None,
                 use_device_canvas=False, batch_window_ms: float = 0.0):
        self.engine = engine
        self.libraries = libraries or {}
        self.library_specs = list(library_specs)
        self.style_seed = style_seed
        self.debug_dir = debug_dir
        self.saved_zs_filename = saved_zs_filename
        self.use_device_canvas = bool(use_device_canvas) \
            and engine.supports_device_render
        self.counters = ServeCounters()
        self.batcher = None
        self.dev_batcher = None
        self.device_executor = None
        if batch_window_ms > 0 and engine.supports_device_render:
            self.batcher = RenderBatcher(engine, batch_window_ms,
                                         self.counters)
            if self.use_device_canvas:
                self.dev_batcher = DeviceRenderBatcher(
                    engine, batch_window_ms, self.counters)
        elif self.use_device_canvas:
            # Unpooled device-canvas strokes render on one thread of their
            # own (the pool batcher has its worker): a stroke is ~1000
            # launches issued by Python under one interpreter lock, and
            # eight render threads served fewer strokes per second than one
            # (PERF.md section 6).
            self.device_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="devcanvas")

    @property
    def fallbacks(self) -> int:
        return self.counters.fallbacks

    @property
    def errors(self) -> int:
        return self.counters.errors

    def session(self, send) -> PaintSession:
        return PaintSession(self, send)

    def warmup(self, canvas=(2000, 2000), level=2, crop_margin=0):
        """What a server warms before it listens: the render paths, the
        batcher's batch sizes when batching, and the pooled render for a
        ``canvas`` at ``level`` when pooling (the client's default canvas
        is 2000 px at level 2)."""
        warmup_engine(self.engine, batched=self.batcher is not None)
        if self.dev_batcher is not None:
            self.dev_batcher.warmup(canvas[0], canvas[1], level=level,
                                    crop_margin=crop_margin)

    def close(self):
        if self.device_executor is not None:
            self.device_executor.shutdown(wait=True)
        if self.dev_batcher is not None:
            self.dev_batcher.close()


def create_core(encoder_checkpoint=None, gan_checkpoint=None, debug_dir=None,
                style_seed=None, enable_z_saving=False, library_specs=None,
                use_device_canvas=False, batch_window_ms: float = 0.0,
                paint_engine=None, device="cuda",
                serve_devices: int = 0, int8: str = "off") -> ServingCore:
    """The engine and library set-up of the JAX ``create_server``, without
    the web application.  Runs on ``device``: raises without CUDA unless
    ``device="cpu"``.  ``serve_devices`` N > 0 splits the batched renders
    over the first N cards (a local mesh, ``parallel/mesh.py``; N entries
    of the CPU with ``device="cpu"``); it raises when fewer exist.
    ``int8="static"`` calibrates the engine's static int8 serving
    (``enable_int8_serving``, where the engine has it) before anything
    renders."""
    if int8 not in ("off", "static"):
        raise ValueError(f"int8 must be 'off' or 'static', got {int8!r}")
    resolve_device(device)
    engine = paint_engine if paint_engine is not None else \
        PaintEngineFactory.create(gan_checkpoint,
                                  encoder_checkpoint=encoder_checkpoint,
                                  device=device)
    if serve_devices > 0:
        from brushstroke_engine_torch.parallel.mesh import make_mesh
        if not hasattr(engine, "set_serving_mesh"):
            raise ValueError(f"{type(engine).__name__} renders on one "
                             f"device; --serve_devices needs a GAN engine")
        engine.set_serving_mesh(make_mesh(serve_devices, device=device,
                                          local=True))
        logger.info("Splitting batched renders over %d devices",
                    serve_devices)
    if int8 == "static" and hasattr(engine, "enable_int8_serving"):
        n = len(engine.enable_int8_serving())
        logger.info("Static-int8 serving: calibrated %d conv sites", n)
    z_file = generate_z_file(gan_checkpoint)
    library_specs = library_specs or []
    libraries = {}
    z_dim = getattr(getattr(engine, "gen_cfg", None), "z_dim", 64)
    for spec_name, _spec_mode, spec_path in library_specs:
        if spec_path == "default":
            spec_path = z_file
        lib = BrushLibrary.from_file(spec_path, z_dim=z_dim)
        mapper = getattr(engine, "uvs_mapper", None)
        if mapper is not None:
            lib.enable_dynamic_icons(mapper)
        libraries[spec_name] = lib
    return ServingCore(
        engine, libraries, library_specs, style_seed=style_seed,
        debug_dir=debug_dir,
        saved_zs_filename=z_file if enable_z_saving else None,
        use_device_canvas=use_device_canvas,
        batch_window_ms=batch_window_ms)
