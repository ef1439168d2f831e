"""Binary websocket protocol for the drawing UI.

The port's copy of ``brushstroke_engine_tpu/ui/protocol.py``: the same bytes
on the wire, identical to the reference (forger/ui/util.py:26-105), so any
client of either server works against the other:

Request (binary):
  uint8[3]  : [debug, num_colors, extra_data]
  uint8[4*n]: per color: [color_idx, R, G, B]
  int32[5]  : [width, height, x, y, crop_margin]
  uint8[...]: RGBA stroke patch (H x W x 4)

Response (binary):
  int32     : type (0/extra = render, 1 = debug image, 2 = brush sample)
  int32[4]  : [width, height, x, y]
  uint8[...]: RGBA image
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def int32_to_binary(value: int) -> bytes:
    return np.array([value], dtype=np.int32).tobytes()


def image_patch_to_binary(img: np.ndarray, x: int, y: int) -> bytes:
    if img.dtype != np.uint8:
        raise RuntimeError("Image must be uint8 in range 0...255")
    height, width, nchannels = img.shape
    assert nchannels < height, f"Wrong shape {img.shape}"
    out = np.array([width, height, x, y], dtype=np.int32).tobytes()
    return out + img.tobytes()


def binary_to_image_patches(bytes_msg: bytes, offset: int = 0
                            ) -> Tuple[Dict, np.ndarray, None]:
    metadata = np.frombuffer(bytes_msg, dtype=np.int32, count=5,
                             offset=offset)
    meta = {"width": int(metadata[0]), "height": int(metadata[1]),
            "x": int(metadata[2]), "y": int(metadata[3]),
            "crop_margin": int(metadata[4])}
    img_data = np.frombuffer(bytes_msg, dtype=np.uint8, offset=offset + 20)
    imgsize = meta["height"] * meta["width"] * 4
    img_stroke = img_data[:imgsize].reshape(
        (meta["height"], meta["width"], 4))
    return meta, img_stroke, None


def decode_render_request_metadata(bytes_msg: bytes, offset: int = 0
                                   ) -> Tuple[Dict, int]:
    metadata = np.frombuffer(bytes_msg, dtype=np.uint8, count=3,
                             offset=offset)
    read_start = offset + 3
    meta = {"debug": bool(metadata[0] != 0), "colors": [],
            "extra_data": int(metadata[2])}
    for _ in range(int(metadata[1])):
        meta["colors"].append(np.frombuffer(bytes_msg, dtype=np.uint8,
                                            count=4, offset=read_start))
        read_start += 4
    return meta, read_start


def encode_render_request(stroke_rgba: np.ndarray, x: int, y: int,
                          crop_margin: int = 0, debug: bool = False,
                          colors=(), extra_data: int = 0) -> bytes:
    """Client-side encoder (for tests and python clients)."""
    h, w = stroke_rgba.shape[:2]
    head = np.array([1 if debug else 0, len(colors), extra_data],
                    dtype=np.uint8).tobytes()
    for (idx, r, g, b) in colors:
        head += np.array([idx, r, g, b], dtype=np.uint8).tobytes()
    head += np.array([w, h, x, y, crop_margin], dtype=np.int32).tobytes()
    return head + stroke_rgba.astype(np.uint8).tobytes()


def decode_render_response(bytes_msg: bytes):
    """Client-side decoder -> (type, meta, rgba image)."""
    rtype = int(np.frombuffer(bytes_msg, dtype=np.int32, count=1)[0])
    meta = np.frombuffer(bytes_msg, dtype=np.int32, count=4, offset=4)
    w, h, x, y = (int(v) for v in meta)
    img = np.frombuffer(bytes_msg, dtype=np.uint8, offset=20)
    img = img.reshape((h, w, -1))
    return rtype, {"x": x, "y": y}, img
