"""jlama_tpu_torch: the PyTorch/CUDA port of jlama_tpu for NVIDIA Hopper.

A package of its own beside `jlama_tpu/` (the JAX reference). It imports
`torch`, never `jax`, and nothing of `jlama_tpu`. Each Pallas kernel on the
ported path has a hand-written CUDA C++ counterpart under `csrc/`, built with
nvcc at first use and bound through ctypes (`ops/_build.py`); beside each
kernel sits its plain PyTorch version, which the wrappers run for tensors on
the CPU only.

Entry points (`models.loader.load_params`, `models.init.init_params`,
`runtime.engine.Engine`) run on the CUDA device unless the caller passes
`device="cpu"`; without a CUDA device and without that argument they raise.
"""

__version__ = "0.1.0"
