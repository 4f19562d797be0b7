from setuptools import find_packages, setup

setup(
    name="mlrun-tpu",
    version="0.1.0",
    description="TPU-native MLOps orchestration framework",
    packages=find_packages(include=["mlrun_tpu", "mlrun_tpu.*",
                                    "mlrun_tpu_torch", "mlrun_tpu_torch.*"]),
    package_data={"mlrun_tpu": ["hub_functions/*/function.yaml",
                                "hub_functions/*/*.py"],
                  # the port's CUDA and host C++ sources, compiled at
                  # first use, and its hub functions
                  "mlrun_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "csrc/*.cpp",
                                      "hub_functions/*/function.yaml"]},
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "pydantic>=2", "aiohttp", "requests", "pyyaml", "click",
        "numpy", "pandas", "fsspec",
    ],
    extras_require={
        "tpu": ["jax[tpu]", "flax", "optax", "orbax-checkpoint", "einops"],
        "cpu": ["jax[cpu]", "flax", "optax", "orbax-checkpoint", "einops"],
        # the PyTorch/CUDA port (mlrun_tpu_torch); its kernels also need
        # the CUDA toolkit's nvcc at first use
        "gpu": ["torch"],
    },
    entry_points={
        "console_scripts": ["mlrun-tpu = mlrun_tpu.__main__:main",
                            # the port's CLI (python3 -m mlrun_tpu_torch)
                            "mlrun-tpu-torch = mlrun_tpu_torch.__main__:main"],
    },
)
