"""Interactive drawing server: HTTP + binary websocket on tornado.

The port's counterpart of ``brushstroke_engine_tpu/ui/server.py``, as a thin
shell around the transport-free serving core (``ui/core.py``), with the same
routes and wire protocol:

  GET /                       drawing UI page (brush libraries in sidebar)
  GET /brush/<lib>/<name>.jpg brush icon JPEG
  WS  /websocket/             binary render requests + JSON control messages

Each websocket carries one :class:`~brushstroke_engine_torch.ui.core.PaintSession`
whose replies go out through ``write_message``.  Start it with

    python -m brushstroke_engine_torch.ui.server --gan_checkpoint B.pkl

(tornado and Pillow needed; the engine runs on CUDA unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import io
import logging
import os
import random
import re

import numpy as np
import tornado.ioloop
import tornado.web
import tornado.websocket

from brushstroke_engine_torch.ui.core import create_core, parse_libraries

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_STATIC_DIR = os.path.join(_PKG_DIR, "static")
_TEMPLATE_DIR = os.path.join(_PKG_DIR, "templates")


class DrawingWebSocketHandler(tornado.websocket.WebSocketHandler):
    """One connection: a core session that replies through this socket."""

    def initialize(self, core):
        self.core = core
        self.session = None

    def open(self):
        self.session = self.core.session(self._send)
        self.session.open()

    def _send(self, msg):
        try:
            self.write_message(msg, binary=isinstance(msg, bytes))
        except tornado.websocket.WebSocketClosedError:
            # The client went away while a stroke was in flight.
            logger.debug("client disconnected; dropping a reply")

    async def on_message(self, message):
        # A coroutine: tornado handles one connection's messages in order,
        # while its awaits let other connections' strokes run.
        await self.session.on_message(message)

    def on_close(self):
        if self.session is not None:
            self.session.on_close()


class IndexHandler(tornado.web.RequestHandler):
    def initialize(self, core):
        self.core = core

    def get(self):
        library_infos = {}
        for spec_name, spec_mode, _path in self.core.library_specs:
            lib = self.core.libraries[spec_name]
            brushes = list(lib.get_style_ids())
            m = re.match(r"rand(\d+)", spec_mode)
            if m is not None:
                random.shuffle(brushes)
                brushes = brushes[:int(m.group(1))]
            library_infos[spec_name] = {"brushes": brushes}
        self.render(os.path.join(_TEMPLATE_DIR, "home.html"),
                    subtitle=self.core.engine.summary(),
                    canvas_width=int(self.get_argument("canvas", 2000)),
                    demo=(self.get_argument("demo", None) is not None),
                    library_infos=library_infos)


class BrushIconHandler(tornado.web.RequestHandler):
    def initialize(self, core):
        self.core = core

    def get(self, library_name, brush_name):
        import PIL.Image
        libraries = self.core.libraries
        image = libraries[library_name].get_style_icon(brush_name) \
            if library_name in libraries else None
        if image is None:
            image = np.zeros((128, 128, 3), dtype=np.uint8)
        img = PIL.Image.fromarray(image)
        if img.mode == "RGBA":
            img = img.convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        self.set_header("Content-Type", "image/jpeg")
        self.write(buf.getvalue())


def create_server(encoder_checkpoint, gan_checkpoint, debug_dir=None,
                  style_seed=None, enable_z_saving=False,
                  library_specs=None, use_device_canvas=False,
                  batch_window_ms: float = 0.0, paint_engine=None,
                  device="cuda"):
    """The tornado application around :func:`ui.core.create_core` (same
    arguments); ``app.core`` is the core, ``app.paint_engine`` its engine
    and ``app.dev_batcher`` its pooled batcher or None."""
    core = create_core(
        encoder_checkpoint=encoder_checkpoint, gan_checkpoint=gan_checkpoint,
        debug_dir=debug_dir, style_seed=style_seed,
        enable_z_saving=enable_z_saving, library_specs=library_specs,
        use_device_canvas=use_device_canvas, batch_window_ms=batch_window_ms,
        paint_engine=paint_engine, device=device)
    app = tornado.web.Application([
        (r"/websocket/", DrawingWebSocketHandler, dict(core=core)),
        (r"/brush/([^/]+)/([^/]+)\.jpg", BrushIconHandler, dict(core=core)),
        (r"/static/(.*)", tornado.web.StaticFileHandler,
         dict(path=_STATIC_DIR)),
        (r"/", IndexHandler, dict(core=core)),
    ])
    app.core = core
    app.paint_engine = core.engine
    app.dev_batcher = core.dev_batcher
    return app


def run_main(argv=None):
    ap = argparse.ArgumentParser(description="Brushstroke engine UI server.")
    ap.add_argument("--gan_checkpoint", type=str, default=None)
    ap.add_argument("--encoder_checkpoint", type=str, default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--debug_dir", type=str, default=None)
    ap.add_argument("--style_seed", type=int, default=None)
    ap.add_argument("--disable_z_saving", action="store_true")
    ap.add_argument("--libraries", type=str, default="Default:random:default")
    ap.add_argument("--device_canvas", action="store_true",
                    help="Keep the per-session feature canvas on the card "
                         "(the whole stroke step there); needs positional "
                         "noise enabled in the client.")
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="Cross-session micro-batching: coalesce render "
                         "requests from all sessions for this many ms and "
                         "render them in one generator pass (0 = off).")
    ap.add_argument("--no_warmup", action="store_true",
                    help="Skip running the render paths once at startup "
                         "(the first stroke then pays the kernel build).")
    ap.add_argument("--precision", choices=["fast", "strict"],
                    default="fast",
                    help="Serving conv/matmul precision: 'fast' (default) "
                         "allows TF32 and runs the frozen encoder in bf16; "
                         "'strict' is true f32 for parity debugging.")
    ap.add_argument("--device", type=str, default="cuda",
                    help="Where the engine runs ('cpu' to run without a "
                         "GPU).")
    ap.add_argument("--log_level", type=int, default=logging.INFO)
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level)
    app = create_server(
        encoder_checkpoint=args.encoder_checkpoint,
        gan_checkpoint=args.gan_checkpoint,
        debug_dir=args.debug_dir,
        style_seed=args.style_seed,
        enable_z_saving=not args.disable_z_saving,
        library_specs=parse_libraries(args.libraries),
        use_device_canvas=args.device_canvas,
        batch_window_ms=args.batch_window_ms,
        device=args.device)
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    set_precision_mode(args.precision)
    if not args.no_warmup:
        app.core.warmup()
    app.listen(args.port)
    logger.info(f"Serving on http://localhost:{args.port}")
    tornado.ioloop.IOLoop.current().start()


if __name__ == "__main__":
    run_main()
