from setuptools import setup, find_packages

setup(
    name="brushstroke_engine_tpu",
    version="0.1.0",
    description=("TPU-native Neural Brushstroke Engine: geometry-conditioned "
                 "StyleGAN2 brush styles with interactive painting, built on "
                 "JAX/XLA for TPU"),
    packages=find_packages(include=["brushstroke_engine_tpu",
                                    "brushstroke_engine_tpu.*",
                                    "brushstroke_engine_torch",
                                    "brushstroke_engine_torch.*"]),
    package_data={
        "brushstroke_engine_tpu.ui": ["static/*", "templates/*"],
        "brushstroke_engine_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "optax",
        "numpy",
        "scipy",
        "Pillow",
        "tornado",
    ],
    extras_require={
        "dev": ["pytest"],
        # The PyTorch/CUDA port (brushstroke_engine_torch); its kernels are
        # built with the CUDA toolkit's nvcc at first use.
        "torch": ["torch"],
    },
)
