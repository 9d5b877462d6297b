"""feed_forward_vqgan_clip_tpu_torch — the PyTorch/CUDA port of
feed_forward_vqgan_clip_tpu for one NVIDIA H100.

The JAX package beside it is the reference: each module here mirrors the JAX
module of the same name and is held against it by tests/test_torch_*.py. Plain
tensor code is PyTorch; the Pallas TPU kernels on the served path are CUDA
kernels written for Hopper (sm_90a) in `csrc/`, built with nvcc at first use
(ops/kernels/build.py). Each kernel's wrapper runs the kernel for a CUDA tensor
and the kernel's plain PyTorch version for a CPU tensor.

The port imports torch and numpy, and never jax, flax or anything of the JAX
package: it keeps its own copy of the constants and sources it needs
(`registry.py`, `native/bpe_core.cc`). yaml is read only where a yaml file is
(`config.load_config`), and Pillow only where JPEGs are decoded
(`data/encode.py`, as the JAX package decodes them).
"""

__version__ = "0.1.0"
