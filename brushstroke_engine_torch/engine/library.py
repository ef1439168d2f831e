"""Brush libraries: named painting styles (z seeds, W vectors + noise
buffers, or fresh random z's) with thumbnail icons and interpolation.

The port's copy of ``brushstroke_engine_tpu/engine/library.py``.  A style is
an immutable :class:`Style` produced by a library's ``resolve``; applying a
style to brush options and interpolating two styles are single functions
over ``Style``.  What the reference file formats force (the seed-txt
grammar, the W-pkl schema, ``RandomState(seed)`` bit-compatibility so brush
identities carry over, the interpolated-style-id grammar, the CLI
library-spec grammar) sits in the "reference format compat" section.
``PIL`` is imported only where an icon is read or written.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import random
import re
import zipfile
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Reference format compat.  These helpers exist to read/write the exact
# artifacts the reference produces; their OUTPUT must match bit-for-bit.
# ---------------------------------------------------------------------------

def parse_seed_file(path: str) -> Tuple[List[int], int]:
    """Seed-txt grammar (reference forger/ui/library.py:48-64): one style per
    line, first token = integer seed, remaining tokens = the saved z (whose
    count fixes z_dim); '#' comments and blanks skipped, bad lines logged."""
    if not os.path.isfile(path):
        return [], 0
    seeds: List[int] = []
    z_dim = 0
    for raw in open(path):
        tokens = raw.strip().split()
        if not tokens or tokens[0].startswith("#"):
            continue
        try:
            seed = int(tokens[0])
        except ValueError:
            logger.error(f"Failed to parse saved seed line {raw.strip()!r} "
                         f"from {path}")
            continue
        seeds.append(seed)
        z_dim = len(tokens) - 1
    return seeds, z_dim


def seed_to_z(seed: int, z_dim: int) -> np.ndarray:
    """Seed -> z, bit-compatible with the reference (library.py:186) so the
    same seed names the same brush across both engines."""
    return np.random.RandomState(seed=seed).randn(1, z_dim)


def interp_style_id(style_id1, style_id2, alpha: float) -> str:
    """Interpolated-style naming grammar (reference library.py:67)."""
    return "%s_%0.2f__%s" % (str(style_id1), alpha, str(style_id2))


def sample_seed_pool(num_seeds: int) -> List[int]:
    """'N' spec semantics (reference library.py:90-95): shuffle the seed
    pool 0..max(10000, N) with the module-level RNG, take the first N."""
    pool = list(range(0, max(10000, num_seeds)))
    random.shuffle(pool)
    return pool[:num_seeds]


def load_styles_pkl(path: str) -> Dict:
    """W-library pkl schema (reference library.py:121-137): a dict mapping
    style_id -> w array OR -> {'w': w, 'noise'|<buffer keys>: ...}.  Raises
    if the payload does not look like that schema."""
    with open(path, "rb") as f:
        styles = pickle.load(f)
    if not isinstance(styles, dict) or not styles:
        raise ValueError(f"not a W library: {path}")
    probe = next(iter(styles.values()))
    probe = probe["w"] if isinstance(probe, dict) else probe
    if _to_numpy(probe).ndim < 2:
        raise ValueError(f"not a W library: {path}")
    return styles


def _to_numpy(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Core model: immutable styles + generic application / interpolation.
# ---------------------------------------------------------------------------

class Style(NamedTuple):
    """A resolved style: ``kind`` is 'z' (latent) or 'w' (pre-mapped, with
    optional per-layer noise buffers keyed 'b{res}.conv{i}.noise_const')."""

    kind: str
    vec: np.ndarray
    noise: Optional[Dict[str, np.ndarray]] = None


def apply_style(style: Style, style_id, brush_options) -> None:
    """Write a resolved style into GanBrushOptions."""
    if style.kind == "w":
        custom = {"noise_buffers": style.noise} if style.noise else {}
        brush_options.set_style_w(style.vec, style_id=style_id,
                                  custom_args=custom)
    else:
        brush_options.set_style(style.vec, style_id=style_id)


def lerp_styles(a: Style, b: Style, alpha: float) -> Style:
    """alpha*a + (1-alpha)*b; noise buffers interpolate only when both
    styles carry them (reference semantics, library.py:165-176)."""
    assert a.kind == b.kind, "cannot interpolate across style kinds"
    noise = None
    if a.noise is not None and b.noise is not None:
        noise = {k: v * alpha + b.noise[k] * (1 - alpha)
                 for k, v in a.noise.items()}
    return Style(a.kind, a.vec * alpha + b.vec * (1 - alpha), noise)


def _free_name(base: str) -> str:
    """``base``, or ``base.1``, ``base.2``, ... : the first that names no
    existing file."""
    name, i = base, 0
    while os.path.lexists(name):
        i += 1
        name = f"{base}.{i}"
    return name


class IconStore:
    """Zip-backed thumbnail cache (stores JPEG per style id)."""

    def __init__(self, path: str, extension: str = ".jpg"):
        self.path = path
        self.extension = extension
        if os.path.lexists(path) and not os.path.isfile(path):
            # A directory, a dangling link or a device: nothing a cache
            # wrote, so nothing to move aside.
            raise OSError(f"icon cache {path} is no regular file")
        if os.path.isfile(path) and not zipfile.is_zipfile(path):
            # A cache whose central directory was never written (only
            # close() writes it, so a killed server leaves one), or a
            # mistyped path naming someone's file.  Append mode would add a
            # zip to its end: move it aside instead, never delete it, and
            # start a fresh cache.
            aside = _free_name(path + ".corrupt")
            try:
                os.rename(path, aside)
            except OSError as e:
                raise OSError(f"icon cache {path} is no zip and cannot be "
                              f"moved aside: {e}") from e
            logger.warning("Icon cache %s is no zip; moved to %s", path,
                           aside)
        self._zip = zipfile.ZipFile(path, mode="a")

    def get(self, style_id) -> Optional[np.ndarray]:
        name = str(style_id) + self.extension
        if name not in self._zip.namelist():
            return None
        import PIL.Image
        with self._zip.open(name, "r") as f:
            return np.array(PIL.Image.open(f))

    def put(self, style_id, image_u8: np.ndarray) -> None:
        import PIL.Image
        img = PIL.Image.fromarray(image_u8)
        if img.mode == "RGBA":
            img = img.convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        self._zip.writestr(str(style_id) + self.extension, buf.getvalue())
        # Persist the central directory NOW: icons render rarely (once per
        # style), and without this a killed process leaves the whole cache
        # unreadable (zipfile writes the directory only on close()).
        self._zip.close()
        self._zip = zipfile.ZipFile(self.path, mode="a")

    def close(self) -> None:
        self._zip.close()


class BrushLibrary:
    """Base: subclasses provide ``style_ids()`` and ``resolve(style_id)``;
    option application, interpolation, and icon plumbing live here."""

    def __init__(self):
        self.icons: Optional[IconStore] = None
        self.mapper = None

    # -- template methods ------------------------------------------------

    def style_ids(self) -> List[str]:
        raise NotImplementedError

    def resolve(self, style_id) -> Style:
        raise NotImplementedError

    # -- public API ------------------------------------------------------

    def get_style_ids(self) -> List[str]:
        return self.style_ids()

    def set_style(self, style_id, brush_options) -> None:
        apply_style(self.resolve(style_id), style_id, brush_options)

    def set_interpolated_style(self, style_id1, style_id2, alpha,
                               brush_options) -> None:
        blended = lerp_styles(self.resolve(style_id1),
                              self.resolve(style_id2), alpha)
        apply_style(blended, interp_style_id(style_id1, style_id2, alpha),
                    brush_options)

    # -- icons -----------------------------------------------------------

    def set_icon_file(self, icon_zipfile: str) -> None:
        self.icons = IconStore(icon_zipfile)

    def enable_dynamic_icons(self, style_mapper) -> None:
        self.mapper = style_mapper

    def get_style_icon(self, style_id) -> Optional[np.ndarray]:
        cached = self.icons.get(style_id) if self.icons is not None else None
        if cached is not None:
            return cached
        if self.mapper is None:
            return None
        from brushstroke_engine_torch.engine.brush import GanBrushOptions
        opts = GanBrushOptions()
        self.set_style(style_id, opts)
        icon = self.mapper.get_brush_icon(opts)
        if self.icons is not None:
            self.icons.put(style_id, icon)
        return icon

    # -- factories (CLI spec grammar, reference library.py:72-108) -------

    @staticmethod
    def from_arg(arg_val: str, z_dim: int = 64) -> "BrushLibrary":
        if os.path.isfile(arg_val):
            return BrushLibrary.from_file(arg_val, z_dim=z_dim)
        rand = re.match(r"^rand(\d+)$", arg_val)
        if rand:
            return RandomBrushLibrary(int(rand.group(1)), zdim=z_dim)
        seeds = [int(x) for x in arg_val.split(",")]
        if len(seeds) == 1:
            seeds = sample_seed_pool(seeds[0])
        return SeedBrushLibrary(seeds, z_dim)

    @staticmethod
    def from_file(fname: str, z_dim: int = 64) -> "BrushLibrary":
        logger.info(f"Parsing file {fname}")
        try:
            lib: BrushLibrary = WBrushLibrary.from_file(fname)
        except Exception:
            logger.info(f"Could not load W library, loading seed library "
                        f"from {fname}")
            lib = SeedBrushLibrary.from_file(fname, z_dim=z_dim)
        try:
            lib.set_icon_file(fname + ".icons.zip")
        except Exception as e:
            logger.warning(f"Could not open icon zip: {e}")
        return lib


class WBrushLibrary(BrushLibrary):
    """Pre-mapped W styles (optionally with per-style noise buffers)."""

    def __init__(self, styles_dict: Dict):
        super().__init__()
        self.styles = styles_dict

    @staticmethod
    def from_file(fname: str) -> "WBrushLibrary":
        lib = WBrushLibrary(load_styles_pkl(fname))
        logger.info(f"Loaded w library with {len(lib.styles)} styles")
        return lib

    def style_ids(self):
        return sorted(self.styles.keys())

    def resolve(self, style_id) -> Style:
        entry = self.styles[style_id]
        noise = None
        if isinstance(entry, dict):
            w = entry["w"]
            buffers = entry.get("noise",
                                {k: v for k, v in entry.items() if k != "w"})
            if buffers:
                noise = {k: _to_numpy(v) for k, v in buffers.items()}
        else:
            w = entry
        w = _to_numpy(w)
        if w.ndim == 2:
            w = w[None]  # -> [1, num_ws, w_dim]
        return Style("w", w, noise)

    def save(self, fname: str) -> None:
        """Write as a pkl of the same schema."""
        with open(fname, "wb") as f:
            pickle.dump(self.styles, f)


class SeedBrushLibrary(BrushLibrary):
    """Integer z seeds; resolution is RandomState bit-compatible with the
    reference so brush identities carry over."""

    def __init__(self, seeds_list: List[int], zdim: int):
        super().__init__()
        self.zs = seeds_list
        self.zdim = zdim

    @staticmethod
    def from_file(fname: str, z_dim: Optional[int] = None
                  ) -> "SeedBrushLibrary":
        seeds, parsed_dim = parse_seed_file(fname)
        logger.info(f"Loaded seed library with {len(seeds)} styles")
        return SeedBrushLibrary(seeds, z_dim if z_dim is not None
                                else parsed_dim)

    def style_ids(self):
        return sorted(str(s) for s in self.zs)

    def resolve(self, style_id) -> Style:
        return Style("z", seed_to_z(int(style_id), self.zdim))


class RandomBrushLibrary(BrushLibrary):
    """N fresh z draws from a stateful RNG: resolving any id draws the NEXT
    sample (reference semantics -- ids name slots, not fixed styles), and
    interpolation degenerates to the first style."""

    def __init__(self, num: int, zdim: int, random_state=None):
        super().__init__()
        self.num = num
        self.zdim = zdim
        self.rng = random_state if random_state is not None \
            else np.random.RandomState(0)

    def style_ids(self):
        return [f"rand{i}" for i in range(self.num)]

    def resolve(self, style_id) -> Style:
        return Style("z", self.rng.randn(1, self.zdim))

    def set_interpolated_style(self, style_id1, style_id2, alpha,
                               brush_options):
        self.set_style(style_id1, brush_options)


def read_zs(saved_file):
    """The seed-txt parser under the JAX package's older name."""
    return parse_seed_file(saved_file)
