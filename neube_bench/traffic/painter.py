"""A closed-loop painter session against the program's serving core.

The benchmark's own copy of the ``Painter`` client of
``brushstroke_engine_torch/tools/bench_serve.py`` (the program may change
its copy; this one is the yardstick's): the client puts its messages in
``inbox`` and a server task hands them to the session one at a time, in
order, as a websocket connection does, so a message waits there while the
loop is busy with other sessions.  ``paint_until`` sends a stroke, waits for
its image and its timing message, and sends the next at once (no think
time) until the deadline.
"""

from __future__ import annotations

import asyncio
import json
import time


class Painter:

    def __init__(self, core, protocol, brush_seed: int, canvas: int,
                 level: int, crop: int, reply_timeout: float):
        self.protocol = protocol
        self.inbox = asyncio.Queue()
        self.replies = asyncio.Queue()
        self.session = core.session(self.replies.put_nowait)
        self.brush_seed = brush_seed
        self.canvas, self.level, self.crop = canvas, level, crop
        self.reply_timeout = reply_timeout
        self.brushinfos = 0
        self.records = []
        self.missing = 0
        self._server = None

    async def _serve(self):
        while True:
            msg = await self.inbox.get()
            if msg is None:
                return
            await self.session.on_message(msg)

    async def _next(self):
        msg = await asyncio.wait_for(self.replies.get(), self.reply_timeout)
        if isinstance(msg, dict) and msg["type"] == "brushinfo":
            self.brushinfos += 1
        return msg

    async def configure(self):
        self._server = asyncio.get_running_loop().create_task(self._serve())
        self.session.open()
        for msg in ({"type": "set_option", "option": "positions",
                     "value": True},
                    {"type": "set_option", "option": "timing",
                     "value": True},
                    {"type": "new_canvas", "rows": self.canvas,
                     "cols": self.canvas, "feature_blending": self.level},
                    {"type": "set_brush", "seed": self.brush_seed}):
            self.inbox.put_nowait(json.dumps(msg))
        while self.brushinfos < 2:        # at connect and after set_brush
            await self._next()

    async def close(self):
        self.inbox.put_nowait(None)
        await self._server
        self.session.on_close()

    async def stroke(self, idx, patch, x, y):
        """One stroke: send, wait for the image and the timing message.
        A reply that does not come within the timeout counts as missing."""
        raw = self.protocol.encode_render_request(patch, x, y,
                                                  crop_margin=self.crop)
        t0 = time.perf_counter()
        self.inbox.put_nowait(raw)
        try:
            while True:
                msg = await self._next()
                if isinstance(msg, bytes):
                    break
            self.protocol.decode_render_response(msg)
            client_ms = (time.perf_counter() - t0) * 1e3
            while True:
                timing = await self._next()
                if isinstance(timing, dict) and timing["type"] == "timing":
                    break
        except asyncio.TimeoutError:
            self.missing += 1
            self.records.append({"stroke": (idx, x, y), "client_ms": None})
            return
        self.records.append({
            "stroke": (idx, x, y), "client_ms": client_ms, "t_done": t0
            + client_ms / 1e3, "timing": timing["data"]})

    async def paint_until(self, plan, deadline: float):
        """Strokes of ``plan`` (patches, [(patch index, x, y)]) in turn,
        continuing where the last call stopped, until ``deadline``
        (perf_counter)."""
        patches, strokes = plan
        while time.perf_counter() < deadline:
            idx, x, y = strokes[len(self.records) % len(strokes)]
            await self.stroke(idx, patches[idx], x, y)
