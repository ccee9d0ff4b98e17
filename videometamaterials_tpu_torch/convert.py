"""Weight bridge between the JAX package's flax parameter tree and this
port's state dict (reference names and layouts), both ways.

The tree is nested dicts of numpy arrays, as `training/msgpack_io.py` (or
`flax.serialization.msgpack_restore`) gives it from a run checkpoint or a
`ckpt_cache/*.msgpack` tree (pass the variables dict `{'params': ...}` or
the params dict itself). The key map is this port's own copy of the
inverse of the JAX package's `training/torch_import.py:build_key_map` for
the configurations the port builds (every padding mode, per-frame and
whole-curve conditioning: to_q, the CNN and GRU embedders), with its own
copies of the layout transforms and their inverses. The GRU is the one
place where leaves do not map one to one: flax's GRUCell keeps a kernel
(and for ir, iz, in, hn a bias) a gate, nn.GRU stacks the gates r|z|n and
has an input and a hidden bias for each. flax -> torch puts the fused r
and z biases in bias_ih and zeros in bias_hh's r and z thirds; torch ->
flax sums them back (the JAX importer's split, read in reverse), so a
state dict whose bias_hh has nonzero r or z thirds comes back with them
moved into bias_ih, the same GRU. Every leaf of the tree must be placed,
and the result loads into the model with `load_state_dict(strict=True)`.

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


def _conv1d(a):           # (k, I, O) -> (O, I, k)
    return a.transpose(2, 1, 0)


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
    _conv1d: lambda t: t.transpose(2, 1, 0),
    _gamma: lambda t: t.reshape(-1),
    _same: lambda t: t,
}


# ------------------------------------------------------------ name map


def _attention(tk: str, fp: tuple) -> dict:
    """Residual(PreNorm(EinopsToAndFrom(Attention)))."""
    e = {f"{tk}.fn.norm.gamma": (fp + ("norm_gamma",), _gamma)}
    for name in ("to_qkv", "to_q", "to_k", "to_v", "to_out"):
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
        f"{inner}.to_q.weight": (fp + ("attn", "to_q", "kernel"), _conv1x1),
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
    # the whole-curve CNN: five Conv1d at Sequential indices 0, 2, 4, 6, 8
    for i in range(5):
        m[f"sign_emb_CNN.emb_model.{2 * i}.weight"] = (
            ("sign_emb_CNN", f"conv1d_{i}", "kernel"), _conv1d)
        m[f"sign_emb_CNN.emb_model.{2 * i}.bias"] = (
            ("sign_emb_CNN", f"conv1d_{i}", "bias"), _same)
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


# ------------------------------------------------------------------ GRU

GRU_LAYERS = 3
_GRU = "sign_emb_GRU"
_GRU_TORCH = ("weight_ih_l{k}", "weight_hh_l{k}", "bias_ih_l{k}",
              "bias_hh_l{k}")


def _gru_cell(k: int) -> tuple:
    return (_GRU, f"gru_cell_{k}")


def _gru_paths(k: int):
    """The flax leaves of GRU layer k: kernels of the six gates, biases of
    ir, iz, in, hn."""
    cell = _gru_cell(k)
    yield from (cell + (g, "kernel") for g in ("ir", "iz", "in",
                                                "hr", "hz", "hn"))
    yield from (cell + (g, "bias") for g in ("ir", "iz", "in", "hn"))


def gru_flax_to_torch(leaves: dict, k: int) -> dict[str, np.ndarray]:
    """nn.GRU's four tensors of layer k from the flax leaves {path: array}
    (gates stacked r|z|n; the fused r, z biases in bias_ih, zeros in
    bias_hh's r and z thirds)."""
    cell = _gru_cell(k)

    def get(gate, leaf):
        return np.asarray(leaves[cell + (gate, leaf)], np.float32)

    zeros = np.zeros_like(get("hn", "bias"))
    names = [f"{_GRU}.emb_model.{n.format(k=k)}" for n in _GRU_TORCH]
    return dict(zip(names, (
        np.concatenate([get(g, "kernel").T for g in ("ir", "iz", "in")]),
        np.concatenate([get(g, "kernel").T for g in ("hr", "hz", "hn")]),
        np.concatenate([get(g, "bias") for g in ("ir", "iz", "in")]),
        np.concatenate([zeros, zeros, get("hn", "bias")]))))


def gru_torch_to_flax(state: dict, k: int) -> dict[tuple, np.ndarray]:
    """The flax leaves of layer k from nn.GRU's tensors {name: array}
    (the JAX importer's _expand_gru_keys): the input and hidden biases of
    r and z summed."""
    w_ih, w_hh, b_ih, b_hh = (
        np.asarray(state[f"{_GRU}.emb_model.{n.format(k=k)}"], np.float32)
        for n in _GRU_TORCH)
    h = w_hh.shape[1]
    cell = _gru_cell(k)
    out = {}
    for gi, gate in enumerate("rzn"):
        sl = slice(gi * h, (gi + 1) * h)
        out[cell + (f"i{gate}", "kernel")] = w_ih[sl].T
        out[cell + (f"h{gate}", "kernel")] = w_hh[sl].T
    out[cell + ("ir", "bias")] = b_ih[:h] + b_hh[:h]
    out[cell + ("iz", "bias")] = b_ih[h:2 * h] + b_hh[h:2 * h]
    out[cell + ("in", "bias")] = b_ih[2 * h:]
    out[cell + ("hn", "bias")] = b_hh[2 * h:]
    return out


def _gru_keys() -> frozenset[str]:
    return frozenset(f"{_GRU}.emb_model.{n.format(k=k)}"
                     for k in range(GRU_LAYERS) for n in _GRU_TORCH)


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
    for k in range(GRU_LAYERS):
        if _gru_cell(k) + ("ir", "kernel") not in leaves:
            continue
        for key, arr in gru_flax_to_torch(leaves, k).items():
            state[key] = torch.tensor(np.ascontiguousarray(arr))
        placed.update(_gru_paths(k))
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
    gru = _gru_keys()
    unknown = sorted(set(state) - set(mapping) - gru)
    if unknown:
        raise KeyError(f"state dict keys with no flax leaf: {unknown[:10]}")
    leaves = {}
    for key, tensor in state.items():
        if key in gru:
            continue
        path, transform = mapping[key]
        arr = np.ascontiguousarray(_INVERSE[transform](
            tensor.detach().cpu().float().numpy()))
        leaves[path] = bfloat16(arr) if key in bf16_keys else arr
    gru_state = {n: t.detach().cpu().float().numpy()
                 for n, t in state.items() if n in gru}
    for k in range(GRU_LAYERS):
        if f"{_GRU}.emb_model.weight_ih_l{k}" in gru_state:
            leaves.update((path, np.ascontiguousarray(arr)) for path, arr
                          in gru_torch_to_flax(gru_state, k).items())
    params: dict = {}
    for path, arr in leaves.items():
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
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
