"""PyTorch port, the temporal forward's two stages on the CPU.

The CUDA forward runs as two launches split where the JAX kernel rounds
the value sum to bf16 (fused_temporal_block.py:235): the attention stage
writes acc (B, F, S, hidden), the out-projection stage adds acc @ w_out to
x. Their plain twins (`temporal_attn_plain`, `temporal_outproj_plain`)
compose into `temporal_block_plain`; here each is held against the JAX
package's reference_temporal_block on numpy inputs, in float32, where
nothing rounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.ops.pallas.fused_temporal_block import (
    reference_temporal_block,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as t_tmp

torch.set_num_threads(1)

# S = 37: not a multiple of any position tile of the kernels (64, 32)
B, F, S = 2, 5, 37
HEADS, D = 4, 32
HD = HEADS * D
# float32 everywhere: the stages and the reference differ in summation
# order and in the LayerNorm's variance (two-pass here, one-pass in the
# reference), a few float32 ulps of O(1) values
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _inputs(n_cond, c):
    return dict(
        x=_rand((B, F, S, c), 0), gamma=_rand((c,), 1, 0.2) + 1.0,
        w_all=_rand((F, c, 3 * HD), 2, 0.1), w_out=_rand((HD, c), 3, 0.1),
        ek=_rand((B, n_cond, HD), 5, 0.5) if n_cond else None,
        ev=_rand((B, n_cond, HD), 6, 0.5) if n_cond else None,
        bias_all=_rand((F, F + n_cond, HEADS), 7, 0.3))


def _torch(a):
    return {k: None if v is None else torch.tensor(v) for k, v in a.items()}


def _jax(a):
    return {k: None if v is None else jnp.asarray(v) for k, v in a.items()}


@pytest.mark.parametrize("n_cond", [0, F])
def test_attention_stage_is_the_reference_value_sum(n_cond):
    """With C = hidden and w_out = I, the JAX reference's out - x is its
    value sum: the attention stage's acc must equal it."""
    a = _inputs(n_cond, HD)
    a["w_out"] = np.eye(HD, dtype=np.float32)
    ta = _torch(a)
    acc, p = t_tmp.temporal_attn_plain(
        ta["x"], ta["gamma"], ta["w_all"], ta["ek"], ta["ev"], ta["bias_all"],
        heads=HEADS)
    assert acc.shape == (B, F, S, HD) and acc.dtype == torch.float32
    assert p.shape == (B, F, F + n_cond, S, HEADS)
    torch.testing.assert_close(p.sum(dim=2), torch.ones(B, F, S, HEADS),
                               **F32_TOL)
    want = np.asarray(reference_temporal_block(**_jax(a), heads=HEADS)) - a["x"]
    np.testing.assert_allclose(acc.numpy(), want, **F32_TOL)


def test_outproj_stage_is_the_residual_projection():
    x, acc, w_out = _rand((B, F, S, 64), 10), _rand((B, F, S, HD), 11), \
        _rand((HD, 64), 12, 0.1)
    got = t_tmp.temporal_outproj_plain(torch.tensor(x), torch.tensor(acc),
                                       torch.tensor(w_out))
    np.testing.assert_allclose(got.numpy(), x + acc @ w_out, **F32_TOL)


@pytest.mark.parametrize("n_cond", [0, F])
def test_stages_compose_to_the_twin_and_the_reference(n_cond):
    a = _inputs(n_cond, 64)
    ta = _torch(a)
    acc, _ = t_tmp.temporal_attn_plain(
        ta["x"], ta["gamma"], ta["w_all"], ta["ek"], ta["ev"], ta["bias_all"],
        heads=HEADS)
    composed = t_tmp.temporal_outproj_plain(ta["x"], acc, ta["w_out"])
    assert torch.equal(composed, t_tmp.temporal_block_plain(**ta, heads=HEADS))
    want = reference_temporal_block(**_jax(a), heads=HEADS)
    np.testing.assert_allclose(composed.numpy(), np.asarray(want), **F32_TOL)
    assert not np.allclose(composed.numpy(), a["x"])


def test_stages_round_like_the_kernel_in_bf16():
    """In bf16 the attention stage rounds qkv, p and acc (the JAX kernel's
    :124, :226, :235) and the out-projection rounds only its result: acc is
    bf16 and the composition is the twin bit for bit."""
    ta = {k: None if v is None else (v if k in ("gamma", "bias_all")
                                     else v.to(torch.bfloat16))
          for k, v in _torch(_inputs(F, 64)).items()}
    acc, p = t_tmp.temporal_attn_plain(
        ta["x"], ta["gamma"], ta["w_all"], ta["ek"], ta["ev"], ta["bias_all"],
        heads=HEADS)
    assert acc.dtype == torch.bfloat16 and p.dtype == torch.bfloat16
    out = t_tmp.temporal_outproj_plain(ta["x"], acc, ta["w_out"])
    assert torch.equal(out, t_tmp.temporal_block_plain(**ta, heads=HEADS))
    out_p, p_w = t_tmp.temporal_block_plain_p(**ta, heads=HEADS)
    assert torch.equal(out_p, out)
    assert torch.equal(p_w, p.permute(0, 1, 3, 2, 4).reshape(B, F, S, -1))


def test_kernels_refuse_operands_off_a_16_byte_boundary():
    """The kernels move 16 bytes at a time (cp.async, vector loads): the
    wrappers' check raises for an operand that starts 2 bytes in."""
    base = torch.zeros(64 * 9, dtype=torch.bfloat16)
    _build.require_aligned(base[:64], None, base[8:72])
    with pytest.raises(ValueError, match="16-byte"):
        _build.require_aligned(base[:64], base[1:65])
