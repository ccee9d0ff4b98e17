"""Model and trainer configuration for the port (own copy; no import of
the JAX package).

The fields of videometamaterials_tpu/config.py:ModelConfig (:23-113) that
sampling, the train step and the artifact export read, and the port's
TrainerConfig (:123-160). The defaults
are the flagship `model.yaml`: dim 64, mults (1, 2, 4, 8), 8 heads x 32,
per-frame self-stacked conditioning, 3 channels x 11 frames x 96 x 96,
bf16 activations over fp32 parameters, both fused kernel families on at
every level, and training on the unfused plans. The conditioning ablation
keys of model.yaml (`unet_cond_attention`, `unet_cond_attention_tokens`,
`unet_cond_att_GRU`) are read; `per_frame_cond: true` overrides the first
two, as in the JAX package. So are the training-side keys `remat_blocks`
(checkpointed ResnetBlocks) and `temporal_s_tile` (the s-tiled temporal
plan); `sample_scan_chunk`, a TPU scan knob, is accepted and dropped.

model.yaml is read and written by a reader and writer of the YAML subset
that model.yaml, model_euler.yaml and `yaml.safe_dump` of a config use
(`load_yaml`, `dump_yaml`; no yaml package): top-level `key: value` lines,
plain and quoted scalars resolved as PyYAML's safe loader resolves them,
block and flow lists of scalars, and comments. Anything else raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import torch


@dataclass(frozen=True)
class ModelConfig:
    selected_channels: Sequence[int] = (0, 1, 3)
    train_timesteps: int = 256
    sampling_timesteps: int = 256             # < train_timesteps = DDIM
    use_dynamic_thres: bool = True
    reference_frame: str = "lagrangian"       # 'lagrangian' | 'eulerian'
    padding_mode: str = "zeros"
    unet_dim: int = 64
    unet_attn_dim_head: int = 32
    unet_attn_heads: int = 8
    unet_resnet_groups: int = 8
    unet_cond_attention: str = "self-stacked"  # 'none' | 'self-stacked' |
                                              # 'cross-attention'
    unet_cond_to_time: str = "add"            # 'add' | 'concat'
    unet_temporal_att_cond: bool = True
    unet_use_sparse_linear_attn: bool = True
    per_frame_cond: bool = True               # forces self-stacked cond
                                              # with one token a frame
    # the whole-curve conditioning of per_frame_cond: false (the ablation
    # study, model.yaml:27-29): tokens = the CNN hidden broadcast to
    # unet_cond_attention_tokens, or the GRU's token a curve point
    unet_cond_att_GRU: bool = False
    unet_cond_attention_tokens: int = 16
    image_size: int = 96
    num_frames: int = 11
    dim_mults: Sequence[int] = (1, 2, 4, 8)
    init_kernel_size: int = 7
    dynamic_thres_percentile: float = 0.9
    ddim_sampling_eta: float = 0.0            # DDIM's noise share (0 = DDIM)
    compute_dtype: str = "bfloat16"           # activations; params fp32
    dynamic_thres_method: str = "bisect"      # 'bisect' | 'sort'
    cfg_rescale: float = 0.0                  # CFG-rescale phi, 0 = off
    cfg_shared_init: bool = True              # init stage once per CFG pair
    use_fused_linear_block: bool | str | int = "all"
    use_fused_temporal_block: bool | str | int = "all"
    bf16_inference_weights: bool = True
    batch_size: int = 4                       # per-device train batch
    learning_rate: float = 1e-4
    loss_type: str = "l1"                     # 'l1' | 'l2'
    # the fused blocks under grad: off = the train step runs the unfused
    # plans on the same parameters (the JAX Trainer's plan split)
    fused_blocks_in_training: bool = False
    # hand-written backward kernels for the fused blocks under grad
    # (instead of autograd through the plain twins)
    fused_bwd_kernels: bool = False
    # temporal backward plan: None (from fused_bwd_kernels) | 'recompute' |
    # 'kernel' | 'saved' (the forward kernel emits the softmax weights,
    # the backward starts from them)
    temporal_vjp: str | None = None
    # torch.utils.checkpoint around each ResnetBlock: recompute its
    # activations in the backward instead of storing them (same gradients)
    remat_blocks: bool = False
    # the unfused temporal blocks in tiles of this many spatial positions
    # where the tile divides h*w and is smaller than it (None = untiled);
    # the fused kernel, where selected, takes precedence
    temporal_s_tile: int | None = None

    def __post_init__(self):
        if self.loss_type not in ("l1", "l2"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        for key, value, allowed in (
                ("unet_cond_attention", self.unet_cond_attention,
                 COND_ATTENTIONS),
                ("unet_cond_to_time", self.unet_cond_to_time, ("add",
                                                               "concat")),
                ("padding_mode", self.padding_mode, PADDING_MODES)):
            if value not in allowed:
                raise ValueError(f"unknown {key} {value!r}: one of "
                                 f"{allowed}")
        temporal_bwd_mode(self.temporal_vjp, self.fused_bwd_kernels)

    @property
    def channels(self) -> int:
        return len(self.selected_channels)

    @property
    def cond_length(self) -> int:
        """The model's conditioning width: one stress a frame, or the
        curve's tail without its first point (data/dataset.py)."""
        return self.num_frames if self.per_frame_cond else CURVE_POINTS - 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


COND_ATTENTIONS = ("none", "self-stacked", "cross-attention")
PADDING_MODES = ("zeros", "circular", "circular_1d")
# points of a stress-strain curve in the data's CSVs
CURVE_POINTS = 51


def temporal_bwd_mode(temporal_vjp: str | None,
                      fused_bwd_kernels: bool) -> str:
    """The fused temporal block's backward under grad, resolved as the JAX
    package does (fused_temporal_block.py:830-833): an explicit plan wins,
    else 'kernel' with fused_bwd_kernels, else the environment's
    VMT_TEMPORAL_VJP, else 'recompute'. Read at each call, as the JAX entry
    point reads it at each trace."""
    if temporal_vjp is None:
        temporal_vjp = "kernel" if fused_bwd_kernels else os.environ.get(
            "VMT_TEMPORAL_VJP", "recompute")
    if temporal_vjp not in ("recompute", "kernel", "saved"):
        raise ValueError(f"unknown temporal_vjp {temporal_vjp!r}")
    return temporal_vjp


@dataclass(frozen=True)
class TrainerConfig:
    """The trainer knobs, with the JAX package's defaults
    (videometamaterials_tpu/config.py:123-160)."""

    train_num_steps: int = 200_000
    save_and_sample_every: int = 10_000
    ema_decay: float = 0.995
    ema_update_every: int = 10
    ema_start_step: int = 2000                # EMA reset before this step
    null_cond_prob: float = 0.1
    guidance_scale: float = 5.0               # milestone and probe sampling
    num_preds: int = 1
    num_samples: int = 3                      # validation curves a milestone
    max_grad_norm: float | None = None        # optax clip_by_global_norm
    # micro-batches an optimizer step (optax.MultiSteps on the mean of
    # their gradients) when above 1, as the JAX Trainer wraps its chain
    gradient_accumulate_every: int = 1
    horizontal_flip: bool = False             # train-set augmentation
    test_batch_size: int = 2                  # sampling takes half of it
    seed: int = 0
    log: bool = True                          # the JAX wandb switch: no wandb
                                              # here, metrics.jsonl either way
    # a sample's chance that its temporal attention attends to its own
    # frame only (the focus-present mask), drawn when above 0
    prob_focus_present: float = 0.0
    checkpoint_backend: str = "msgpack"       # 'orbax' needs orbax
    keep_last_checkpoints: int | None = None  # None = keep every milestone
    # the milestone fidelity probe: a target CSV, its first n targets, the
    # predictions per target (best-of-N pixel-curve NRMSE)
    fidelity_probe_targets: str | None = None
    fidelity_probe_n_targets: int = 2
    fidelity_probe_preds: int = 2

    def __post_init__(self):
        if self.checkpoint_backend != "msgpack":
            raise NotImplementedError(
                f"checkpoint backend {self.checkpoint_backend!r}: only "
                "'msgpack' is ported. The orbax backend needs the orbax "
                "and tensorstore packages, which the port's installation "
                "(torch, numpy, scipy) does not have")

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


# Keys of model.yaml the port does not read (the TPU sampler's scan
# chunking): accepted by the reader and dropped.
_UNREAD_KEYS = frozenset(("sample_scan_chunk",))

# ------------------------------------------------------ the YAML subset

# PyYAML's YAML 1.1 resolver for plain scalars, on the forms the subset
# takes (decimal ints, floats with a dot, .inf and .nan)
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$"
                    r"|[-+]?\.(?:inf|Inf|INF)$|\.(?:nan|NaN|NAN)$")
_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
# plain scalars PyYAML resolves to something the subset does not take
# (YAML 1.1 booleans, other int bases, sexagesimal numbers)
_UNSUPPORTED = re.compile(
    r"(?:y|Y|yes|Yes|YES|n|N|no|No|NO|on|On|ON|off|Off|OFF)$"
    r"|[-+]?0[0-9bxo_]|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:[ \t]+(.*))?$")


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: str):
    text = text.strip()
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'" or "'" in text[1:-1].replace(
                "''", ""):
            raise ValueError(f"{where}: bad single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"' or any(
                c in text[1:-1] for c in '"\\'):
            raise ValueError(f"{where}: unsupported double-quoted scalar "
                             f"{text!r}")
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.replace("_", "").lower()
        if low.endswith("inf"):
            return -math.inf if low.startswith("-") else math.inf
        return math.nan if low == ".nan" else float(low)
    if _UNSUPPORTED.match(text) or text[0] in "[]{},&*!|>%@`-?:" \
            or ": " in text or " #" in text:
        raise ValueError(f"{where}: unsupported YAML scalar {text!r}")
    return text


def load_yaml(text: str, source: str = "<yaml>") -> dict:
    """A mapping of scalars and lists of scalars from the YAML subset
    (equal to what yaml.safe_load gives for it); raises on the rest."""
    out: dict = {}
    pending = None                  # key whose block list is open
    blocks = set()                  # keys with no value on their line
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}: tab indentation")
        item = re.match(r"([ ]*)- (.*)$|([ ]*)-$", line)
        if item:
            if pending is None:
                raise ValueError(f"{where}: list item outside a list")
            value = item.group(2) or ""
            if value.lstrip()[:1] in ("[", "{") or re.match(
                    r"-( |$)", value.lstrip()) or _KEY.match(value.strip()):
                raise ValueError(f"{where}: nested collections are not "
                                 "supported")
            out[pending].append(_scalar(value, where))
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: nested mappings are not supported")
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"{where}: not a 'key: value' line: {line!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        pending = None
        if not value:
            out[key] = []
            pending = key
            blocks.add(key)
        elif value[0] == "[":
            if value[-1] != "]" or "[" in value[1:] or "{" in value:
                raise ValueError(f"{where}: unsupported flow list {value!r}")
            body = value[1:-1].strip()
            out[key] = [_scalar(v, where) for v in body.split(",")] \
                if body else []
        else:
            out[key] = _scalar(value, where)
    # a key with neither a value nor list items is null, as in YAML
    return {k: None if k in blocks and not v else v for k, v in out.items()}


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)      # YAML 1.1 needs the dot
        return text
    if isinstance(v, str):
        if "\n" in v:
            raise ValueError(f"multi-line string {v!r}")
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as a YAML scalar")


def dump_yaml(d: dict) -> str:
    """The YAML subset's text of a mapping of scalars and lists of scalars
    (block lists, quoted strings), which yaml.safe_load reads back equal."""
    lines = []
    for k, v in d.items():
        if not _KEY.match(f"{k}:"):
            raise ValueError(f"bad key {k!r}")
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}: []" if not v else f"{k}:")
            lines.extend(f"- {_dump_scalar(x)}" for x in v)
        else:
            lines.append(f"{k}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"


def load_model_yaml(path: str | Path) -> ModelConfig:
    """Read a model.yaml (the JAX package's keys; those the port does not
    read are dropped, unknown keys raise)."""
    raw = load_yaml(Path(path).read_text(), str(path)) or {}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(raw) - known - _UNREAD_KEYS
    if unknown:
        raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
    kw = {k: v for k, v in raw.items() if k in known}
    if "learning_rate" in kw:
        kw["learning_rate"] = float(kw["learning_rate"])
    for key in ("selected_channels", "dim_mults"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)


def save_model_yaml(cfg: ModelConfig, path: str | Path) -> None:
    """Snapshot a config (every field, in field order)."""
    d = dataclasses.asdict(cfg)
    for key in ("selected_channels", "dim_mults"):
        d[key] = list(d[key])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(dump_yaml(d))


def snapshot_run_config(cfg: ModelConfig, run_dir: str | Path) -> Path:
    """Create runs/<name>/model/model.yaml once; an existing snapshot is
    kept (it is re-read on resume), as the JAX package does."""
    run_dir = Path(run_dir)
    yaml_path = run_dir / "model" / "model.yaml"
    if yaml_path.exists():
        return yaml_path
    (run_dir / "training").mkdir(parents=True, exist_ok=True)
    save_model_yaml(cfg, yaml_path)
    return yaml_path


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on the GPU unless the caller names a
    device. With no GPU and no explicit device they raise instead of quietly
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_precision() -> None:
    """fp32 products and convolutions in full fp32 (no TF32) on the card,
    so the fp32 parts of the model match the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
