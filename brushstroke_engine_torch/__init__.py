"""PyTorch/CUDA port of the brushstroke engine for one NVIDIA H100.

Mirrors ``brushstroke_engine_tpu`` module by module (``ops/``, ``models/``,
``engine/``, ``utils/``, ``data/``) and imports nothing from it.  Public
functions keep the JAX package's layouts (NHWC activations, the same
parameter-tree keys); weights are held in torch layouts (OIHW convs,
``[out, in]`` linears).  Entry points run on ``device="cuda"`` unless the
caller asks for ``"cpu"``.
"""
