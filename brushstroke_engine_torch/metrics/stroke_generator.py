"""Batched evaluation harness over the paint engine.

Counterpart of ``brushstroke_engine_tpu/metrics/stroke_generator.py``:
seeded style and color generation (the JAX package's numpy draws) and
batched stroke renders for the metric loops and FID.  Renders stay on the
engine's device as tensors.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from brushstroke_engine_torch.engine.brush import (
    GanBrushOptions, PaintEngineFactory,
)


class RandomState:
    """Seeded numpy RNG with the reference's seed semantics."""

    def __init__(self, seed, max_style_seed: int = 10000):
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.max_style_seed = max_style_seed

    def generate_style_seed(self) -> int:
        return int(self.rng.randint(0, self.max_style_seed))

    def random_tensor(self, shape) -> np.ndarray:
        return self.rng.rand(*shape).astype(np.float32)

    def generate_style_seeds(self, num):
        return [self.generate_style_seed() for _ in range(num)]


class RandomStyleGenerator:
    """Iterate random (or seeded) single-batch styles."""

    @staticmethod
    def create_from_seeds(seeds, generator):
        return RandomStyleGenerator(generator, seeds=seeds)

    @staticmethod
    def create_without_seeds(num, generator):
        return RandomStyleGenerator(generator, num=num)

    def __init__(self, generator, seeds=None, num=None):
        self.generator = generator
        self.seeds = seeds
        self.num = num if seeds is None else len(seeds)
        self.idx = 0

    def __iter__(self):
        self.idx = 0
        return self

    def __next__(self):
        if self.idx >= self.num:
            raise StopIteration
        seed = None if self.seeds is None else self.seeds[self.idx]
        self.idx += 1
        return self.generator.get_random_style(seed=seed)


class PaintStrokeGenerator:
    """Batched stroke renderer for evaluation."""

    @staticmethod
    def create(encoder_checkpoint, gan_checkpoint, batch_size,
               random_state=None, seed=None, device="cuda"):
        """An engine from ``gan_checkpoint`` on ``device`` (raises without
        CUDA unless ``device="cpu"``)."""
        engine = PaintEngineFactory.create(
            gan_checkpoint, encoder_checkpoint=encoder_checkpoint,
            device=device)
        if random_state is None:
            random_state = RandomState(seed)
        return PaintStrokeGenerator(batch_size, engine, random_state)

    def __init__(self, batch_size, paint_engine, random_state: RandomState,
                 primary_color_idx: int = 0):
        self.random_state = random_state
        self.batch_size = batch_size
        self.geom_iter: Optional[Iterator] = None
        self.engine = paint_engine
        self.brush_options = GanBrushOptions()
        self.geom: Optional[np.ndarray] = None       # [B, W, W, 1], 0 = FG
        self.geom_truth: Optional[np.ndarray] = None
        self.primary_color_idx = primary_color_idx
        self.gic = 1
        self.gtc = 2

    # ----- configuration -----

    def set_render_mode(self, mode):
        self.engine.set_render_mode(mode)

    def set_geometry_source_from_iterator(self, iterator, batch_size,
                                          geom_input_channel=1,
                                          geom_truth_channel=2):
        self.geom_iter = iterator
        self.batch_size = batch_size
        self.gic = geom_input_channel
        self.gtc = geom_truth_channel

    # ----- colors -----

    def random_colors(self) -> np.ndarray:
        return self.random_state.random_tensor((self.batch_size, 3))

    def random_color(self) -> np.ndarray:
        c = self.random_state.random_tensor((1, 3))
        return np.tile(c, (self.batch_size, 1))

    def set_random_colors(self):
        for i in range(3):
            self.set_new_color(i, self.random_colors())

    def unset_colors(self):
        for i in range(3):
            self.brush_options.set_color(i, None)

    def set_new_primary_color(self, colors=None):
        self.set_new_color(self.primary_color_idx, colors)

    def set_new_color(self, color_idx, colors=None):
        self.brush_options.set_color(color_idx, colors)

    # ----- geometry -----

    def set_new_geom(self, geom=None):
        """geom: ``[B, W, W, 1]`` float [0, 1] (0 = FG), or None to pull
        from the configured iterator (uint8 triband ``[B, H, W, 3]``,
        centre-cropped to the patch width)."""
        if geom is not None:
            assert geom.shape[0] == self.batch_size
            self.geom = np.asarray(geom, np.float32)
            return
        assert self.geom_iter is not None
        batch = next(self.geom_iter)
        batch = np.asarray(batch, np.float32) / 255.0
        w = self.engine.patch_width
        if batch.shape[1] != w or batch.shape[2] != w:
            y = (batch.shape[1] - w) // 2
            x = (batch.shape[2] - w) // 2
            batch = batch[:, y:y + w, x:x + w]
        self.geom = batch[..., self.gic:self.gic + 1]
        self.geom_truth = batch[..., self.gtc:self.gtc + 1]

    # ----- styles -----

    def get_random_styles(self, seeds=None, return_seeds=False):
        if seeds is not None:
            assert len(seeds) == self.batch_size
        elif return_seeds:
            seeds = self.random_state.generate_style_seeds(self.batch_size)
        if seeds is not None:
            styles = np.concatenate(
                [self.engine.random_style(s) for s in seeds], axis=0)
        else:
            z_dim = self.engine.gen_cfg.z_dim
            styles = self.random_state.rng.randn(
                self.batch_size, z_dim).astype(np.float32)
        if return_seeds:
            return styles, seeds
        return styles

    def get_random_style(self, seed=None, return_seed=False):
        z_dim = self.engine.gen_cfg.z_dim
        if seed is None and not return_seed:
            z = self.random_state.rng.randn(1, z_dim)
            return np.tile(z, (self.batch_size, 1)).astype(np.float32)
        if seed is None:
            seed = self.random_state.generate_style_seed()
        style = np.tile(self.engine.random_style(seed),
                        (self.batch_size, 1)).astype(np.float32)
        if return_seed:
            return style, seed
        return style

    def set_new_styles(self, style_z):
        self.brush_options.set_style(style_z, -1)

    def current_styles(self):
        return self.brush_options.style_z

    # ----- rendering -----

    def generate_raw(self):
        """(rgba ``[B, W, W, 4]`` tensor, the render core's output dict)."""
        assert self.geom is not None, "Must call set_new_geom first"
        self.brush_options.prepare_style(self.batch_size)
        rgba, raw, _ = self.engine._render_stroke_device(
            self.geom, None, self.brush_options)
        return rgba, raw

    def generate(self, rgb_on_white_canvas: bool = False):
        """``[B, W, W, 4]`` float render tensor on the engine's device (or
        ``[B, W, W, 3]`` over white)."""
        rgba, _ = self.generate_raw()
        if rgb_on_white_canvas:
            alpha = rgba[..., 3:4]
            return alpha * rgba[..., :3] + (1 - alpha)
        return rgba
