"""Serve a trained model with brush libraries and paint over the websocket.

The port's counterpart of ``scripts/drive_brush_server.py``, with its flags
plus ``--device``: it launches the real server process (``python -m
brushstroke_engine_torch.ui.server``) with the given ``--libraries`` spec,
connects a websocket client, and for one brush of every library paints a
six-stroke squiggle with positional noise on, compositing the returned
patches client-side as the JS client does.  It writes a stroke sheet per
library, one brush icon per library fetched over ``/brush/<lib>/<style>.jpg``
and ``report.json`` (per library: the style, stroke latencies, the colours
of its brushinfo, the icon's size).

It needs tornado (the server and the client); the card's machine has none,
so there it runs with ``--device cpu`` on a machine that has tornado:

    python -m brushstroke_engine_torch.tools.drive_brush_server \\
        --gan_checkpoint SNAP --libraries "Seeds:disp:seeds.txt" \\
        --out_dir D --port 8741 --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def stroke_patch(width: int, seed: int = 0) -> np.ndarray:
    """A thick wavy stroke mask in an RGBA uint8 patch (the client sends
    the stroke geometry as the user's painted alpha mask)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.15, 0.85, 64)
    amp = 0.18 + 0.1 * rng.rand()
    xs = t * width
    ys = (0.5 + amp * np.sin(t * (4 + 2 * rng.rand()) + rng.rand())) * width
    yy, xx = np.mgrid[0:width, 0:width]
    d = np.min((xx[..., None] - xs) ** 2 + (yy[..., None] - ys) ** 2, -1)
    mask = (d < (width * 0.09) ** 2).astype(np.uint8) * 255
    patch = np.zeros((width, width, 4), np.uint8)
    patch[..., 3] = mask
    patch[..., :3] = mask[..., None]
    return patch


async def paint_session(url, libraries, canvas_px, out_dir):
    """One websocket session: per library, select its first brush, paint
    six strokes and composite them; returns the report."""
    import tornado.websocket
    from brushstroke_engine_torch.ui import protocol
    from brushstroke_engine_torch.utils.img_proc import write_image

    ws = await tornado.websocket.websocket_connect(url)
    msg = json.loads(await ws.read_message())
    assert msg["type"] == "modelinfo", msg
    patch_width = int(msg["data"]["patch_width"])
    first_info = json.loads(await ws.read_message())
    assert first_info["type"] == "brushinfo", first_info

    # new_canvas rows / cols are pixels, rounded up to whole patches.
    side = int(np.ceil(canvas_px / patch_width)) * patch_width
    ws.write_message(json.dumps({"type": "new_canvas", "rows": side,
                                 "cols": side, "feature_blending": 1}))
    ws.write_message(json.dumps({"type": "set_option",
                                 "option": "positions", "value": 1}))

    async def read_binary():
        while True:
            raw = await ws.read_message()
            if raw is None:
                raise RuntimeError("socket closed")
            if not isinstance(raw, str):
                return raw

    report = {"patch_width": patch_width, "libraries": {}}
    for li, (lib_id, style_ids) in enumerate(libraries.items()):
        style_id = style_ids[0]
        ws.write_message(json.dumps({"type": "set_brush",
                                     "library_id": lib_id,
                                     "style_id": str(style_id)}))
        info = json.loads(await ws.read_message())
        assert info["type"] == "brushinfo", info
        assert info["data"]["style_id"] == str(style_id), (info, style_id)

        canvas = np.zeros((side, side, 4), np.float32)
        canvas[..., :3] = 1.0
        lat = []
        n_strokes = 6
        for si in range(n_strokes):
            x = int((si % 3) * patch_width * 0.8) + 4
            y = int((si // 3) * patch_width * 0.7) + li * 3 + 4
            t0 = time.time()
            ws.write_message(protocol.encode_render_request(
                stroke_patch(patch_width, seed=100 * li + si),
                x, y, 0, False, (), 0), binary=True)
            rtype, meta, rgba = protocol.decode_render_response(
                await read_binary())
            lat.append(1e3 * (time.time() - t0))
            assert rgba.shape[-1] == 4 and rgba.max() > 0
            # The client's composite: putImage with alpha.
            px, py = meta["x"], meta["y"]
            h = min(rgba.shape[0], side - py)
            w = min(rgba.shape[1], side - px)
            a = rgba[:h, :w, 3:].astype(np.float32) / 255.0
            rgb = rgba[:h, :w, :3].astype(np.float32) / 255.0
            dst = canvas[py:py + h, px:px + w]
            dst[..., :3] = a * rgb + (1 - a) * dst[..., :3]
            dst[..., 3:] = np.maximum(dst[..., 3:], a)

        write_image(os.path.join(out_dir, f"strokes_{lib_id}.png"),
                    (canvas[..., :3] * 255).astype(np.uint8))
        report["libraries"][lib_id] = {
            "style_id": str(style_id),
            "n_styles": len(style_ids),
            "n_strokes": n_strokes,
            "stroke_ms_p50": float(np.percentile(lat, 50)),
            "stroke_ms_max": float(np.max(lat)),
            "brushinfo_colors": info["data"].get("colors", ""),
        }
        print(f"[{lib_id}] {len(style_ids)} styles; painted {n_strokes} "
              f"strokes with '{style_id}', p50 {np.percentile(lat, 50):.1f} "
              f"ms")
    ws.close()
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--libraries", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--port", type=int, default=8741)
    ap.add_argument("--canvas_px", type=int, default=256)
    ap.add_argument("--startup_timeout", type=float, default=600.0)
    ap.add_argument("--no_warmup", action="store_true",
                    help="Skip the server's render warm-up.")
    ap.add_argument("--device", default="cuda",
                    help="Where the server's engine runs ('cpu' without a "
                         "GPU).")
    args = ap.parse_args(argv)
    from brushstroke_engine_torch.utils.util import resolve_device
    resolve_device(args.device)     # no server without the device asked for

    os.makedirs(args.out_dir, exist_ok=True)

    from brushstroke_engine_torch.engine.library import BrushLibrary
    from brushstroke_engine_torch.ui.core import (
        generate_z_file, parse_libraries,
    )

    # Style ids from the library files as the server reads them ('default'
    # is the checkpoint's saved-zs file); the protocol addresses a brush by
    # (library_id, style_id).
    libraries = {}
    for name, _mode, path in parse_libraries(args.libraries):
        if path == "default":
            path = generate_z_file(args.gan_checkpoint)
        ids = BrushLibrary.from_file(path).get_style_ids()
        assert ids, f"library {name} ({path}) is empty"
        libraries[name] = ids

    cmd = [sys.executable, "-m", "brushstroke_engine_torch.ui.server",
           "--gan_checkpoint", args.gan_checkpoint,
           "--libraries", args.libraries, "--port", str(args.port),
           "--disable_z_saving", "--device_canvas",
           "--device", args.device]
    if args.encoder_checkpoint:
        cmd += ["--encoder_checkpoint", args.encoder_checkpoint]
    if args.no_warmup:
        cmd += ["--no_warmup"]
    log_path = os.path.join(args.out_dir, "server.log")
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=lf, cwd=REPO)
    try:
        deadline = time.time() + args.startup_timeout
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"server died; see {log_path}")
            with open(log_path) as f:
                if "Serving on" in f.read():
                    break
            time.sleep(0.5)
        else:
            raise RuntimeError("server startup timed out")

        url = f"ws://localhost:{args.port}/websocket/"
        report = asyncio.new_event_loop().run_until_complete(
            paint_session(url, libraries, args.canvas_px, args.out_dir))

        # The HTTP icon path, one icon per library.
        import urllib.request
        for name, ids in libraries.items():
            icon_url = (f"http://localhost:{args.port}/brush/{name}/"
                        f"{ids[0]}.jpg")
            try:
                data = urllib.request.urlopen(icon_url, timeout=120).read()
                with open(os.path.join(args.out_dir, f"icon_{name}.jpg"),
                          "wb") as f:
                    f.write(data)
                report["libraries"][name]["icon_bytes"] = len(data)
            except Exception as e:  # random libraries serve no icon
                report["libraries"][name]["icon_error"] = str(e)

        with open(os.path.join(args.out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        print("served-strokes evidence written to", args.out_dir)
        return report
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


if __name__ == "__main__":
    main()
