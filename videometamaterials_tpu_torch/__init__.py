"""videometamaterials_tpu_torch — the PyTorch/CUDA port of videometamaterials_tpu.

The JAX package beside it is the reference. This package imports torch,
numpy, scipy and the standard library only; it keeps its own copies of the
framework-free pieces it needs (config, label normalization, the data
folder's statistics, GIF I/O, geometry cleanup, the artifact export).

Slice 1 covers guided DDPM sampling of the flagship UNet3D, slice 2 its
train step (loss, gradient, Adam, EMA), slice 3 the `temporal_vjp: saved`
plan and the head-layout linear forward (`VMT_LINEAR_LAYOUT=head`), slice 8
the path from a `.msgpack` checkpoint to GIFs and geometries.csv:
  config.py            ModelConfig (defaults = the flagship model.yaml),
                       TrainerConfig, the model.yaml reader and writer
  ops/                 schedules, norms, rotary, relative bias, convs,
                       attention cores
  ops/cuda/            hand-written sm_90a kernels (fused temporal block,
                       with or without its softmax weights out, and its
                       backward; fused linear-attention stats + apply, the
                       head-layout forward and the backward; the
                       deterministic reductions), their
                       plain PyTorch twins, the autograd.Functions and the
                       nvcc/ctypes loader
  models/              UNet3D and its embeddings
  diffusion/           GaussianDiffusion: CFG, thresholding, DDPM chain, loss
  data/                label normalizer, batch sampler, the training
                       folder's labels and ranges, the GIF codec (numpy)
  postproc/            geometry cleanup (scipy)
  training/            Adam and the global-norm clip, the train step,
                       Trainer, target evaluation; flax's msgpack format,
                       checkpoints, the artifact export
  convert.py           flax parameter tree <-> torch state dict
  main.py              entry point: guided target evaluation of a run's
                       checkpoint to GIFs and geometries.csv
  sample.py            entry point: guided sampling to .npy
  train.py             entry point: training on the benchmark workload
"""

__version__ = "0.1.0"
