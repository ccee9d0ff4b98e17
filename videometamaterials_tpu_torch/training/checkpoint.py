"""Checkpoints of a run: the port's copy of the JAX package's
training/checkpoint.py (msgpack backend) and of the restore half of
scripts/persist_demo_ckpt.py.

Directory contract: runs/<name>/model/step_<N>/checkpoint.msgpack (flax's
msgpack format of {step, params, opt_state, ema_params}, through
`msgpack_io`) and aux.json (labels_scaling, step). Trees are nested dicts
of numpy arrays in flax's layout (`convert.torch_to_flax_tree`).

- strict restore: params and ema_params must have the template's structure
  and shapes (raises otherwise);
- tolerant restore (strict=False): leaves graft where path and shape
  match, with a warning for every other leaf (JAX `_graft`);
- opt_state is optax's state of the JAX Trainer's chain (adam, or
  clip_by_global_norm then adam) in flax's layout: adam's own chain is
  A = {'0': {'count', 'mu', 'nu'}, '1': {}}, the Trainer's {'0': A}, or
  with the clip {'0': {}, '1': A},
  which `optimizer_state_tree` and `load_optimizer_state` map to and from
  torch's Adam state (step, exp_avg, exp_avg_sq per parameter); under
  gradient accumulation that chain is the inner state of optax.MultiSteps,
  {'mini_step', 'gradient_step', 'inner_opt_state', 'acc_grads',
  'skip_state': {}} (flax's layout of MultiStepsState), mapped to and from
  `optim.MultiSteps`; a run checkpoint of either package resumes in the
  other;
- `read_train_checkpoint` refuses a step restored from a ckpt_cache tree
  (its params are the bf16 EMA, it has no optimizer state);
- prune_checkpoints keeps the newest N step directories.

The orbax backend is not ported (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    torch_to_flax_tree,
)
from videometamaterials_tpu_torch.training.msgpack_io import (
    read_msgpack,
    write_msgpack,
)
from videometamaterials_tpu_torch.training.optim import MultiSteps

_SECTIONS = ("params", "ema_params")


def _ckpt_dir(results_folder: str | Path, step: int) -> Path:
    return Path(results_folder) / "model" / f"step_{step}"


def _check_backend(backend: str) -> None:
    if backend != "msgpack":
        raise NotImplementedError(
            f"checkpoint backend {backend!r}: only 'msgpack' is ported "
            "(the orbax backend waits for ROADMAP.md Queue 1 item 5)")


def save_checkpoint(results_folder: str | Path, step: int, payload: dict,
                    aux: Optional[dict] = None, backend: str = "msgpack",
                    keep_last: Optional[int] = None) -> Path:
    """Write payload ({step, params, opt_state, ema_params}: a tree of
    numpy arrays) to runs/<name>/model/step_<step>/checkpoint.msgpack, aux
    as aux.json beside it; with keep_last, prune all but the newest
    keep_last step directories."""
    _check_backend(backend)
    d = _ckpt_dir(results_folder, step)
    d.mkdir(parents=True, exist_ok=True)
    path = d / "checkpoint.msgpack"
    write_msgpack(path, payload)
    if aux is not None:
        (d / "aux.json").write_text(json.dumps(aux))
    if keep_last is not None:
        prune_checkpoints(results_folder, keep_last)
    return path


def _graft(template, raw, path: str, warn: list):
    """Copy leaves of `raw` onto the structure of `template` wherever the
    path exists and the shape matches; report everything else."""
    t_leaf, r_leaf = not isinstance(template, dict), not isinstance(raw, dict)
    if t_leaf or r_leaf:
        if t_leaf != r_leaf:
            warn.append(f"structure mismatch at {path or '<root>'}")
            return template
        t, r = np.asarray(template), np.asarray(raw)
        if t.shape != r.shape:
            warn.append(f"shape mismatch at {path}: "
                        f"ckpt {r.shape} vs model {t.shape}")
            return template
        return r.astype(t.dtype)
    out = {}
    for k in template:
        if k in raw:
            out[k] = _graft(template[k], raw[k], f"{path}/{k}", warn)
        else:
            warn.append(f"missing in checkpoint: {path}/{k}")
            out[k] = template[k]
    for k in raw:
        if k not in template:
            warn.append(f"unexpected in checkpoint: {path}/{k}")
    return out


def _strict(template, raw, path: str):
    """flax's from_state_dict onto the template, then the shape check of
    the JAX strict restore: every template key must be in the checkpoint
    (extra checkpoint keys are ignored), leaves keep the checkpoint's
    values and dtype."""
    if not isinstance(template, dict):
        if isinstance(raw, dict):
            raise ValueError(f"structure mismatch at {path}")
        if np.shape(template) != np.shape(raw):
            raise ValueError(f"shape mismatch at {path}: ckpt "
                             f"{np.shape(raw)} vs model {np.shape(template)}")
        return raw
    if not isinstance(raw, dict):
        raise ValueError(f"structure mismatch at {path}")
    missing = sorted(set(template) - set(raw))
    if missing:
        raise ValueError(f"the checkpoint lacks {missing} at {path}")
    return {k: _strict(v, raw[k], f"{path}/{k}") for k, v in template.items()}


def read_checkpoint(results_folder: str | Path, step: int) -> dict:
    """The raw tree of runs/<name>/model/step_<step>/checkpoint.msgpack,
    as written (no template, no restore)."""
    d = _ckpt_dir(results_folder, step)
    path = d / "checkpoint.msgpack"
    if not path.exists():
        if (d / "orbax").exists():
            _check_backend("orbax")
        raise FileNotFoundError(
            f"trainer checkpoint not found at {path}. Please check path or "
            "run load_model_step = None")
    return read_msgpack(path)


def load_checkpoint(results_folder: str | Path, step: int, template: dict,
                    strict: bool = True) -> tuple[dict, Optional[dict]]:
    """Restore runs/<name>/model/step_<step> into the structure of
    template's params and ema_params. Returns (payload, aux): payload has
    'step', the restored sections and the checkpoint's raw 'opt_state' (if
    it has one); aux is aux.json (None without one)."""
    raw = read_checkpoint(results_folder, step)
    payload = {"step": raw.get("step", template.get("step"))}
    for section in _SECTIONS:
        if section not in template:
            continue
        if strict:
            if section not in raw:
                raise ValueError(f"the checkpoint has no {section}")
            payload[section] = _strict(template[section], raw[section],
                                       section)
        else:
            warn: list = []
            payload[section] = _graft(template[section],
                                      raw.get(section, {}), section, warn)
            for w in warn:
                warnings.warn(f"checkpoint restore ({section}): {w}",
                              stacklevel=2)
    if "opt_state" in raw:
        payload["opt_state"] = raw["opt_state"]
    aux_path = _ckpt_dir(results_folder, step) / "aux.json"
    aux = json.loads(aux_path.read_text()) if aux_path.exists() else None
    return payload, aux


def read_train_checkpoint(results_folder: str | Path,
                          step: int) -> tuple[dict, Optional[dict]]:
    """(the raw tree, aux.json or None) of a checkpoint that training can
    resume from: one with an optimizer state, not restored from a
    ckpt_cache tree."""
    d = _ckpt_dir(results_folder, step)
    aux_path = d / "aux.json"
    aux = json.loads(aux_path.read_text()) if aux_path.exists() else None
    if aux and aux.get("restored_from_cache"):
        raise ValueError(
            f"cannot resume training from step {step} of {results_folder}: "
            "it was restored from a ckpt_cache tree (restored_from_cache in "
            f"{aux_path}), so its params are the bf16 EMA and it has no "
            "optimizer state; train from scratch or from a trainer "
            "checkpoint")
    raw = read_checkpoint(results_folder, step)
    if not raw.get("opt_state"):
        raise ValueError(f"cannot resume training from step {step} of "
                         f"{results_folder}: the checkpoint has no "
                         "optimizer state")
    return raw, aux


def optimizer_state_tree(optimizer: torch.optim.Optimizer,
                         named_params, clipped: bool,
                         accum: Optional[MultiSteps] = None) -> dict:
    """optax's state of adam (after clip_by_global_norm when `clipped`) for
    a torch Adam over named_params ((name, parameter) in the model's
    order): count = the steps taken, mu / nu = exp_avg / exp_avg_sq in
    flax's layout (zeros before the first step); with `accum`, that chain's
    state inside optax.MultiSteps'."""
    named_params = list(named_params)
    count, mu, nu = 0, {}, {}
    for name, p in named_params:
        st = optimizer.state.get(p)
        if st:
            count = int(st["step"])
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[name] = nu[name] = torch.zeros_like(p, dtype=torch.float32)
    adam = {"0": {"count": np.asarray(count, np.int32),
                  "mu": torch_to_flax_tree(mu),
                  "nu": torch_to_flax_tree(nu)},
            "1": {}}
    chain = {"0": {}, "1": adam} if clipped else {"0": adam}
    if accum is None:
        return chain
    return {"mini_step": np.asarray(accum.mini_step, np.int32),
            "gradient_step": np.asarray(accum.gradient_step, np.int32),
            "inner_opt_state": chain,
            "acc_grads": torch_to_flax_tree(
                {name: acc for (name, _), acc in zip(named_params,
                                                     accum.acc_grads)}),
            "skip_state": {}}


_MULTI_STEPS_KEYS = {"mini_step", "gradient_step", "inner_opt_state",
                     "acc_grads", "skip_state"}


def load_optimizer_state(tree: dict, optimizer: torch.optim.Optimizer,
                         named_params, clipped: bool,
                         accum: Optional[MultiSteps] = None) -> int:
    """Set a torch Adam's state from optax's (the inverse of
    optimizer_state_tree), and with `accum` the MultiSteps counters and
    accumulated gradients around it; returns Adam's count. Raises when the
    tree is not that chain's state or does not fit the parameters."""
    what = "clip_by_global_norm + adam" if clipped else "adam"
    named_params = list(named_params)
    if accum is not None:
        what = f"MultiSteps({what})"
        if not isinstance(tree, dict) or set(tree) != _MULTI_STEPS_KEYS:
            raise ValueError(f"opt_state is not optax's state of {what}")
        acc = flax_to_torch_state_dict(tree["acc_grads"])
        if set(acc) != {n for n, _ in named_params} or any(
                acc[n].shape != p.shape for n, p in named_params):
            raise ValueError(f"the accumulated gradients of {what} do not "
                             "fit the model's parameters")
        mini_step = int(np.asarray(tree["mini_step"]))
        if not 0 <= mini_step < accum.k:
            raise ValueError(f"mini_step {mini_step} of {what} outside "
                             f"[0, {accum.k})")
        count = load_optimizer_state(tree["inner_opt_state"], optimizer,
                                     named_params, clipped)
        accum.mini_step = mini_step
        accum.gradient_step = int(np.asarray(tree["gradient_step"]))
        for (name, _), a in zip(named_params, accum.acc_grads):
            a.copy_(acc[name].to(a.device, torch.float32))
        return count
    try:
        adam = tree["1" if clipped else "0"]["0"]
        count, mu, nu = int(np.asarray(adam["count"])), adam["mu"], adam["nu"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"opt_state is not optax's state of {what}") from e
    mu, nu = flax_to_torch_state_dict(mu), flax_to_torch_state_dict(nu)
    named = named_params
    if set(mu) != {n for n, _ in named} or set(nu) != set(mu):
        raise ValueError(f"the optimizer state of {what} does not fit the "
                         "model's parameters")
    for name, p in named:
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"optimizer state shape mismatch at {name}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, torch.float32).contiguous(),
            "exp_avg_sq": nu[name].to(p.device, torch.float32).contiguous()}
    return count


def _checkpoint_steps(model_dir: Path):
    for d in model_dir.iterdir():
        if d.is_dir() and d.name.startswith("step_") and \
                ((d / "checkpoint.msgpack").exists()
                 or (d / "orbax").exists()):
            yield int(d.name.split("_")[1])


def prune_checkpoints(results_folder: str | Path, keep_last: int) -> list:
    """Delete all but the newest keep_last step directories; returns the
    removed steps."""
    model_dir = Path(results_folder) / "model"
    if not model_dir.exists():
        return []
    steps = sorted(_checkpoint_steps(model_dir))
    removed = []
    for s in steps[:max(0, len(steps) - keep_last)]:
        shutil.rmtree(model_dir / f"step_{s}", ignore_errors=True)
        removed.append(s)
    return removed


def latest_checkpoint_step(results_folder: str | Path) -> Optional[int]:
    model_dir = Path(results_folder) / "model"
    if not model_dir.exists():
        return None
    steps = list(_checkpoint_steps(model_dir))
    return max(steps) if steps else None


def restore_from_cache(cache_tree: str | Path, run_dir: str | Path,
                       step: int) -> Path:
    """A ckpt_cache EMA tree (<run>_step_<N>.msgpack and its .aux.json) as
    the run checkpoint runs/<name>/model/step_<step>/ with params := ema
    and no optimizer state; aux.json carries restored_from_cache
    (scripts/persist_demo_ckpt.py `restore`)."""
    src = Path(cache_tree)
    raw = read_msgpack(src)
    payload = {"step": raw["step"], "params": raw["ema_params"],
               "ema_params": raw["ema_params"]}
    aux = {"step": step, "restored_from_cache": True}
    aux_src = src.with_suffix(".aux.json")
    if aux_src.exists():
        aux = {**json.loads(aux_src.read_text()), **aux}
    save_checkpoint(run_dir, step, payload, aux)
    return _ckpt_dir(run_dir, step)

