"""Data parallelism: process groups (``distributed``) and device meshes
(``mesh``); counterpart of ``brushstroke_engine_tpu/parallel``."""

from brushstroke_engine_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_batch, replicate, make_dp_train_step,
    shard_tile_render,
)
