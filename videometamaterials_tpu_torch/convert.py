"""Weight bridge between the JAX package's flax parameter tree and this
port's state dict (reference names and layouts), both ways.

The tree is nested dicts of numpy arrays, as `training/msgpack_io.py` (or
`flax.serialization.msgpack_restore`) gives it from a run checkpoint or a
`ckpt_cache/*.msgpack` tree (pass the variables dict `{'params': ...}` or
the params dict itself). The key map is this port's own copy of the
inverse of the JAX package's `training/torch_import.py:build_key_map` for
the configurations the port builds (zeros padding, per-frame
conditioning), with its own copies of the layout transforms and their
inverses. Every leaf of the tree must be placed, and the result loads
into the model with `load_state_dict(strict=True)`.

`load_msgpack_tree` reads a checkpoint's EMA tree; `save_state_dict_npz` /
`load_state_dict_npz` carry a converted state dict as one numpy file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from videometamaterials_tpu_torch.training.msgpack_io import (
    bfloat16,
    read_msgpack,
)

# ------------------------------------------- flax layout -> torch layout


def _linear(a):           # (in, out) -> (out, in)
    return a.T


def _conv_spatial(a):     # (kh, kw, I, O) -> (O, I, 1, kh, kw)
    return a.transpose(3, 2, 0, 1)[:, :, None]


def _conv1x1(a):          # (I, O) -> (O, I, 1, 1, 1)
    return a.T[:, :, None, None, None]


def _conv_transpose(a):   # flipped (kh, kw, I, O) -> (I, O, 1, kh, kw)
    return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1][:, :, None]


def _gamma(a):            # (C,) -> (1, C, 1, 1, 1)
    return a.reshape(1, -1, 1, 1, 1)


def _same(a):
    return a


# the inverse of each transform: torch layout -> flax layout
_INVERSE = {
    _linear: lambda t: t.T,
    _conv_spatial: lambda t: t[:, :, 0].transpose(2, 3, 1, 0),
    _conv1x1: lambda t: t[:, :, 0, 0, 0].T,
    _conv_transpose: lambda t: t[:, :, 0, ::-1, ::-1].transpose(2, 3, 0, 1),
    _gamma: lambda t: t.reshape(-1),
    _same: lambda t: t,
}


# ------------------------------------------------------------ name map


def _attention(tk: str, fp: tuple) -> dict:
    """Residual(PreNorm(EinopsToAndFrom(Attention)))."""
    e = {f"{tk}.fn.norm.gamma": (fp + ("norm_gamma",), _gamma)}
    for name in ("to_qkv", "to_k", "to_v", "to_out"):
        e[f"{tk}.fn.fn.fn.{name}.weight"] = (
            fp + ("attn", f"{name}_kernel"), _linear)
    return e


def _linear_attention(tk: str, fp: tuple) -> dict:
    """Residual(PreNorm(SpatialLinearAttention))."""
    inner = f"{tk}.fn.fn"
    return {
        f"{tk}.fn.norm.gamma": (fp + ("norm_gamma",), _gamma),
        f"{inner}.to_qkv.weight": (fp + ("attn", "to_qkv", "kernel"),
                                   _conv1x1),
        f"{inner}.to_k.weight": (fp + ("attn", "to_k", "kernel"), _linear),
        f"{inner}.to_v.weight": (fp + ("attn", "to_v", "kernel"), _linear),
        f"{inner}.to_out.weight": (fp + ("attn", "to_out_kernel"), _conv1x1),
        f"{inner}.to_out.bias": (fp + ("attn", "to_out_bias"), _same),
    }


def _resnet(tk: str, fp: tuple) -> dict:
    e = {f"{tk}.mlp.1.weight": (fp + ("time_mlp", "kernel"), _linear),
         f"{tk}.mlp.1.bias": (fp + ("time_mlp", "bias"), _same),
         f"{tk}.res_conv.weight": (fp + ("res_kernel",), _conv1x1),
         f"{tk}.res_conv.bias": (fp + ("res_bias",), _same)}
    for blk in ("block1", "block2"):
        e[f"{tk}.{blk}.proj.weight"] = (fp + (blk, "conv_kernel"),
                                        _conv_spatial)
        e[f"{tk}.{blk}.proj.bias"] = (fp + (blk, "conv_bias"), _same)
        e[f"{tk}.{blk}.norm.weight"] = (fp + (blk, "gn_scale"), _same)
        e[f"{tk}.{blk}.norm.bias"] = (fp + (blk, "gn_bias"), _same)
    return e


def key_map(num_resolutions: int) -> dict:
    """torch key -> (flax path under 'params', flax -> torch transform)."""
    m = {
        "init_conv.weight": (("init_conv_kernel",), _conv_spatial),
        "init_conv.bias": (("init_conv_bias",), _same),
        "time_rel_pos_bias.relative_attention_bias.weight": (
            ("time_rel_pos_bias", "relative_attention_bias"), _same),
        "time_mlp.1.weight": (("time_mlp_1", "kernel"), _linear),
        "time_mlp.1.bias": (("time_mlp_1", "bias"), _same),
        "time_mlp.3.weight": (("time_mlp_2", "kernel"), _linear),
        "time_mlp.3.bias": (("time_mlp_2", "bias"), _same),
        "sign_emb.weight": (("sign_emb", "kernel"), _linear),
        "sign_emb.bias": (("sign_emb", "bias"), _same),
        "cond_token_to_hidden.0.weight": (("cond_hidden_norm", "scale"),
                                          _same),
        "cond_token_to_hidden.0.bias": (("cond_hidden_norm", "bias"), _same),
        "cond_token_to_hidden.1.weight": (("cond_hidden_1", "kernel"),
                                          _linear),
        "cond_token_to_hidden.1.bias": (("cond_hidden_1", "bias"), _same),
        "cond_token_to_hidden.3.weight": (("cond_hidden_2", "kernel"),
                                          _linear),
        "cond_token_to_hidden.3.bias": (("cond_hidden_2", "bias"), _same),
        "null_text_token": (("null_text_token",), _same),
        "null_text_hidden": (("null_text_hidden",), _same),
        "final_conv.1.weight": (("final_conv_kernel",), _conv1x1),
        "final_conv.1.bias": (("final_conv_bias",), _same),
    }
    m.update(_attention("init_temporal_attn", ("init_temporal_attn",)))
    for i in range(num_resolutions):
        for stage, side in (("downs", "down"), ("ups", "up")):
            tk, fp = f"{stage}.{i}", f"{side}_{i}"
            m.update(_resnet(f"{tk}.0", (fp + "_block1",)))
            m.update(_resnet(f"{tk}.1", (fp + "_block2",)))
            m.update(_linear_attention(f"{tk}.2", (fp + "_spatial_attn",)))
            m.update(_attention(f"{tk}.3", (fp + "_temporal_attn",)))
        m[f"downs.{i}.4.weight"] = ((f"down_{i}_downsample", "kernel"),
                                    _conv_spatial)
        m[f"downs.{i}.4.bias"] = ((f"down_{i}_downsample", "bias"), _same)
        m[f"ups.{i}.4.weight"] = ((f"up_{i}_upsample", "kernel"),
                                  _conv_transpose)
        m[f"ups.{i}.4.bias"] = ((f"up_{i}_upsample", "bias"), _same)
    for name in ("mid_block1", "mid_block2"):
        m.update(_resnet(name, (name,)))
    m.update(_attention("mid_spatial_attn", ("mid_spatial_attn",)))
    m.update(_attention("mid_temporal_attn", ("mid_temporal_attn",)))
    final = _resnet("final_conv.0", ("final_block",))
    m.update({k: v for k, v in final.items() if ".mlp." not in k})
    return m


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Convert a flax UNet3D parameter tree to the port's state dict
    (float32 tensors). Raises if a leaf of the tree has no place."""
    params = tree["params"] if "params" in tree else tree
    leaves = dict(_leaves(params))
    num_res = sum(1 for k in params if k.startswith("down_")
                  and k.endswith("_block1"))
    state, placed = {}, set()
    for key, (path, transform) in key_map(num_res).items():
        if path not in leaves:
            continue              # module absent in this configuration
        arr = transform(np.asarray(leaves[path], dtype=np.float32))
        state[key] = torch.tensor(np.ascontiguousarray(arr))
        placed.add(path)
    unplaced = sorted("/".join(p) for p in set(leaves) - placed)
    if unplaced:
        raise KeyError(f"flax leaves with no place in the port: "
                       f"{unplaced[:10]}")
    return state


def torch_to_flax_tree(state: dict[str, torch.Tensor],
                       bf16_keys=frozenset()) -> dict:
    """The inverse of flax_to_torch_state_dict: the variables dict
    `{'params': ...}` of a port state dict, float32 numpy leaves, and
    bfloat16 (`msgpack_io.bfloat16`, rounded to nearest even) for the torch
    keys in bf16_keys (the leaves the JAX inference cast makes bf16:
    `utils.inference_cast_keys`). Keys sorted, as flax writes them."""
    num_res = sum(1 for k in state if k.startswith("downs.")
                  and k.endswith(".0.block1.proj.weight"))
    mapping = key_map(num_res)
    unknown = sorted(set(state) - set(mapping))
    if unknown:
        raise KeyError(f"state dict keys with no flax leaf: {unknown[:10]}")
    params: dict = {}
    for key, tensor in state.items():
        path, transform = mapping[key]
        arr = np.ascontiguousarray(_INVERSE[transform](
            tensor.detach().cpu().float().numpy()))
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = bfloat16(arr) if key in bf16_keys else arr
    return {"params": _sorted(params)}


def _sorted(tree: dict) -> dict:
    """Keys in sorted order at every level, as flax writes a tree."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def load_msgpack_tree(path) -> dict:
    """The EMA parameter tree of a `.msgpack` checkpoint: a run checkpoint
    (`runs/<name>/model/step_<N>/checkpoint.msgpack`: step, params,
    opt_state, ema_params) or a `ckpt_cache` tree (step, ema_params)."""
    return read_msgpack(path)["ema_params"]


def save_state_dict_npz(state: dict[str, torch.Tensor], path) -> None:
    np.savez(path, **{k: v.detach().cpu().float().numpy()
                      for k, v in state.items()})


def load_state_dict_npz(path) -> dict[str, torch.Tensor]:
    with np.load(Path(path)) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}
