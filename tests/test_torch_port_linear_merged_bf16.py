"""PyTorch port, the merged linear-attention forward in bf16 on the CPU: the
stats and apply twins composed (what the CUDA stats and apply kernels are
held to on the card) against the JAX package's merged-layout kernel in
interpret mode, on the same bf16 inputs made with numpy.

tests/test_torch_port_kernels.py holds the same pairing in float32, where
only the summation order differs; there a rounding point of v, pk, qn,
ctx or oh that moved would not show. Here it would, but not in the size of
the error: one bf16 rounding moves a value by at most 2^-8 of it, inside
any tolerance on the update. It shows in how many outputs differ. Where
both round at the same points, only an f32 sum that lands on the other
side of a bf16 rounding boundary flips an output, which is rare; a twin
that keeps one of the five values in f32 flips about a third of them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.ops.pallas.fused_linear_block import (
    fused_linear_block as j_fused_linear,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as t_lin
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

torch.set_num_threads(1)

# shapes of tests/test_fused_linear_block.py (and of the float32 pairing)
B, N, C = 6, 16, 8
HEADS, D = 4, 32
HD = HEADS * D
KW = dict(heads=HEADS, scale=D ** -0.5, spatial_size=N)
# the update out - x - out_bias against the JAX kernel's, relative to its
# largest element: the twin and the kernel round at the same points, so
# what is left is the f32 summation order (a bf16 value near a rounding
# boundary flips one ulp, 2^-8 of it) and the final rounding of out
UPDATE_TOL = 3e-2
# share of the bf16 outputs whose bits may differ from the JAX kernel's:
# the twins as they are stay far below it; leaving any one of v, pk, qn,
# ctx or oh unrounded goes far above it
# (test_bit_share_sees_one_rounding_point_moved)
BITS_SHARE = 0.03
# inputs with an update as large as x: v columns times HW (undoing v / HW)
# and keys times 8, so the token weights are no flat average near zero
V_SCALE, K_SCALE = float(N), 8.0


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _bf16(a):
    """numpy float32 rounded to bf16 (nearest even), kept as float32, so
    both frameworks start from the same bf16 values."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _inputs(n_cond, seed):
    w_qkv = _rand((C, 3 * HD), seed + 2, C ** -0.5)
    w_qkv[:, HD:2 * HD] *= K_SCALE
    w_qkv[:, 2 * HD:] *= V_SCALE
    return dict(
        x=_bf16(_rand((B, N, C), seed)),
        gamma=_rand((C,), seed + 1, 0.2) + 1.0,
        w_qkv=_bf16(w_qkv),
        w_out=_bf16(_rand((HD, C), seed + 3, 12 * HD ** -0.5)),
        out_bias=_rand((C,), seed + 4, 0.1),
        ek=_bf16(_rand((B, n_cond, HD), seed + 5)) if n_cond else None,
        ev=_bf16(_rand((B, n_cond, HD), seed + 6)) if n_cond else None)


def _torch(a, name):
    if a is None:
        return None
    t = torch.tensor(a)
    return t if name in ("gamma", "out_bias") else t.to(torch.bfloat16)


def _jax(a, name):
    if a is None:
        return None
    return jnp.asarray(a, jnp.float32 if name in ("gamma", "out_bias")
                       else jnp.bfloat16)


def _twins(t):
    """linear_stats_plain composed with linear_apply_plain."""
    ctx, z = t_lin.linear_stats_plain(t["x"], t["gamma"], t["w_qkv"],
                                      t["ek"], t["ev"], heads=HEADS,
                                      spatial_size=N)
    return t_lin.linear_apply_plain(t["x"], t["gamma"], t["w_qkv"],
                                    t["w_out"], t["out_bias"], ctx, z,
                                    heads=HEADS, scale=KW["scale"])


def _twins_written_out(t, unrounded=None):
    """The two twins' arithmetic written out, with the bf16 rounding of
    `unrounded` (one of v, pk, qn, ctx, oh; None for none) left out."""
    x, cdt, hidden = t["x"], t["x"].dtype, HD

    def rnd(name, a):
        return a if name == unrounded else a.to(cdt).float()

    b, n, _ = x.shape
    y = channel_layer_norm(x, t["gamma"], one_pass=False).to(cdt).float()
    q, k, v = (y @ t["w_qkv"].float()).split(hidden, dim=-1)
    if t["ek"] is not None:
        k = torch.cat([k, t["ek"].float()], dim=1)
        v = torch.cat([v, t["ev"].float()], dim=1)
    pk = torch.exp(k.clamp(-t_lin.K_CLAMP, t_lin.K_CLAMP))
    ctx = torch.einsum("bnha,bnhe->bhae",
                       rnd("pk", pk).reshape(b, -1, HEADS, D),
                       rnd("v", v * (1.0 / N)).reshape(b, -1, HEADS, D))
    q = q.reshape(b, n, HEADS, D)
    e = torch.exp(q - q.amax(dim=-1, keepdim=True))
    brd = KW["scale"] / e.sum(dim=-1, keepdim=True)
    qn = rnd("qn", (e * brd).reshape(b, n, hidden)
             * (1.0 / pk.sum(dim=1))[:, None, :])
    oh = torch.einsum("bnha,bhae->bnhe", qn.reshape(b, n, HEADS, D),
                      rnd("ctx", ctx))
    oh = rnd("oh", oh).reshape(b, n, hidden)
    out = x.float() + t["out_bias"].float() + oh @ t["w_out"].float()
    return out.to(cdt)


def _bits_share(got, want):
    """Share of bf16 outputs whose bits differ."""
    return (got.view(torch.int16).numpy()
            != np.asarray(want).view(np.int16)).mean()


@pytest.mark.parametrize("seed", [0, 10])
@pytest.mark.parametrize("n_cond", [0, 1])
def test_merged_twins_match_jax_kernel_in_bf16(n_cond, seed):
    args = _inputs(n_cond, seed)
    t = {k: _torch(v, k) for k, v in args.items()}
    before = dict(_build.LAUNCH_COUNTS)
    got = _twins(t)
    assert _build.LAUNCH_COUNTS == before
    assert got.dtype == torch.bfloat16
    want = j_fused_linear(*[_jax(v, k) for k, v in args.items()],
                          interpret=True, layout="merged", **KW)
    assert want.dtype == jnp.bfloat16
    base = args["x"] + args["out_bias"]
    upd_t = got.float().numpy() - base
    upd_j = np.asarray(want.astype(jnp.float32)) - base
    assert np.isfinite(upd_t).all()
    # the update must stand out of x's bf16 rounding for the check to see it
    assert np.sqrt((upd_j ** 2).mean()) > 0.5 * np.sqrt((args["x"] ** 2).mean())
    err = np.abs(upd_t - upd_j).max()
    assert err <= UPDATE_TOL * np.abs(upd_j).max(), (err, np.abs(upd_j).max())
    share = _bits_share(got, want)
    print(f"update err {err / np.abs(upd_j).max():.4f} of its max, "
          f"bit share {share:.4f}")
    assert share <= BITS_SHARE


@pytest.mark.parametrize("unrounded", ["v", "pk", "qn", "ctx", "oh"])
def test_bit_share_sees_one_rounding_point_moved(unrounded):
    """The bit share can fail: the twins written out equal the twins bit
    for bit, and with any one rounding left out they differ from the JAX
    kernel in more than BITS_SHARE of the outputs (while the update stays
    within UPDATE_TOL: the size of the error cannot see it)."""
    args = _inputs(1, 0)
    t = {k: _torch(v, k) for k, v in args.items()}
    assert torch.equal(_twins_written_out(t), _twins(t))
    got = _twins_written_out(t, unrounded)
    want = j_fused_linear(*[_jax(v, k) for k, v in args.items()],
                          interpret=True, layout="merged", **KW)
    base = args["x"] + args["out_bias"]
    upd_j = np.asarray(want.astype(jnp.float32)) - base
    err = np.abs(got.float().numpy() - base - upd_j).max()
    share = _bits_share(got, want)
    print(f"{unrounded} unrounded: update err {err / np.abs(upd_j).max():.4f}"
          f" of its max, bit share {share:.4f}")
    assert err <= UPDATE_TOL * np.abs(upd_j).max()
    assert share > BITS_SHARE
