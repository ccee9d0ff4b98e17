"""videometamaterials_tpu_torch — the PyTorch/CUDA port of videometamaterials_tpu.

The JAX package beside it is the reference. This package imports torch,
numpy and the standard library only; it keeps its own copies of the
framework-free pieces it needs (config, label normalization).

Slice 1 covers guided DDPM sampling of the flagship UNet3D:
  config.py            ModelConfig (defaults = the flagship model.yaml)
  ops/                 schedules, norms, rotary, relative bias, convs,
                       attention cores
  ops/cuda/            hand-written sm_90a kernels (fused temporal block,
                       fused linear-attention stats + apply), their plain
                       PyTorch twins and the nvcc/ctypes loader
  models/              UNet3D and its embeddings
  diffusion/           GaussianDiffusion: CFG, thresholding, DDPM chain
  data/normalization   label normalizer (numpy)
  convert.py           flax parameter tree -> torch state dict
  sample.py            entry point: guided sampling to .npy
"""

__version__ = "0.1.0"
