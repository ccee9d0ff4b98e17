# -*- coding: utf-8 -*-
"""videometamaterials_tpu_torch -- the PyTorch/CUDA port of videometamaterials_tpu.

The JAX package beside it is the reference. This package imports torch,
numpy, scipy and the standard library only; it keeps its own copies of the
framework-free pieces it needs (config, label normalization, the GIF-folder
dataset, GIF I/O, geometry cleanup, the artifact export, the fidelity
scoring).

Slice 1 covers guided DDPM sampling of the flagship UNet3D, slice 2 its
train step (loss, gradient, Adam, EMA), slice 3 the `temporal_vjp: saved`
plan and the head-layout linear forward (`VMT_LINEAR_LAYOUT=head`), slice 8
the path from a `.msgpack` checkpoint to GIFs and geometries.csv, slice 9
training from a GIF folder with milestones and resume, slice 10 DDIM,
interpolation, guidance arms, the reference checkpoint.pt import and the
FEM-verification stack:
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
  diffusion/           GaussianDiffusion: CFG, thresholding, DDPM and DDIM
                       chains, interpolation, loss
  data/                label normalizer, batch sampler and prefetching
                       stream, the GIF-folder VideoDataset, the GIF codec
                       and resize (numpy), the synthetic dataset folders
  postproc/            geometry cleanup (scipy), NRMSE and best-of-N
                       scores, grid cells and the remap's cleanup, the
                       pixel-estimated curve
  fem/                 GRF geometries, the sketch plan, the in-Abaqus model
                       builder (Python 2.7, under Abaqus CAE), the wrapper
                       that runs it and turns its CSVs into GIFs
  training/            Adam and the global-norm clip, the train step,
                       Trainer (GIF folder, milestones, resume), the
                       fidelity probe's scoring, target evaluation; flax's
                       msgpack format, checkpoints (optax's Adam state),
                       the reference checkpoint.pt import, the artifact
                       export
  parallel/            data parallelism across processes (one a device;
                       NCCL, gloo): the process group, padded row splits,
                       the gathers, the bucketed gradient mean
  convert.py           flax parameter tree <-> torch state dict
  graft_entry.py       entry points: the flagship's guided forward, and
                       dryrun_multichip (a data-parallel train step and
                       sampling chunk over n ranks)
  main.py              entry point: training on a GIF folder, and guided
                       target evaluation (DDPM or DDIM, guidance arms) to
                       GIFs and geometries.csv
  eval_abaqus.py       entry point: FEM verification of a generated
                       geometry with Abaqus
  sample.py            entry point: guided sampling to .npy
  train.py             entry point: training on the benchmark workload
"""

__version__ = "0.1.0"
