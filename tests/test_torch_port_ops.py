"""PyTorch port, ops layer: each function against its JAX counterpart on the
same numpy inputs, in float32 on the CPU.

Tolerance: 1e-5 relative/absolute unless stated; both sides compute in
float32 and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.data import normalization as j_norm
from videometamaterials_tpu.data.dataset import interpolate_labels as j_interp
from videometamaterials_tpu.models import embeddings as j_emb
from videometamaterials_tpu.ops import attention as j_att
from videometamaterials_tpu.ops import conv as j_conv
from videometamaterials_tpu.ops import norms as j_norms
from videometamaterials_tpu.ops import relative_bias as j_rb
from videometamaterials_tpu.ops import rotary as j_rot
from videometamaterials_tpu.ops import schedules as j_sched
from videometamaterials_tpu_torch.config import ModelConfig, load_model_yaml
from videometamaterials_tpu_torch.data import normalization as t_norm
from videometamaterials_tpu_torch.models import embeddings as t_emb
from videometamaterials_tpu_torch.ops import attention as t_att
from videometamaterials_tpu_torch.ops import conv as t_conv
from videometamaterials_tpu_torch.ops import norms as t_norms
from videometamaterials_tpu_torch.ops import relative_bias as t_rb
from videometamaterials_tpu_torch.ops import rotary as t_rot
from videometamaterials_tpu_torch.ops import schedules as t_sched

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def test_config_defaults_are_the_flagship_model_yaml():
    assert load_model_yaml("model.yaml") == ModelConfig()
    cfg = ModelConfig()
    assert (cfg.unet_dim, tuple(cfg.dim_mults), cfg.unet_attn_heads,
            cfg.unet_attn_dim_head, cfg.channels, cfg.num_frames,
            cfg.image_size) == (64, (1, 2, 4, 8), 8, 32, 3, 11, 96)
    assert cfg.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("timesteps", [8, 256])
def test_schedule_tables(timesteps):
    j = j_sched.make_schedule(timesteps)
    t = t_sched.make_schedule(timesteps, "cpu")
    for name in ("betas", "alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


@pytest.mark.parametrize("one_pass", [True, False])
def test_channel_layer_norm(one_pass, monkeypatch):
    monkeypatch.setattr(j_norms, "ONE_PASS_STATS", one_pass)
    x, g = _rand((2, 3, 5, 16), 0, 3.0) + 1.5, _rand((16,), 1) + 1.0
    _close(t_norms.channel_layer_norm(torch.tensor(x), torch.tensor(g),
                                      one_pass=one_pass),
           j_norms.channel_layer_norm(jnp.asarray(x), jnp.asarray(g)))


def test_group_norm():
    x = _rand((2, 3, 4, 4, 16), 2, 2.0) + 0.5
    s, b = _rand((16,), 3) + 1.0, _rand((16,), 4)
    _close(t_norms.group_norm(torch.tensor(x), torch.tensor(s),
                              torch.tensor(b), 4),
           j_norms.group_norm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b), 4))


@pytest.mark.parametrize("dim_head", [32, 8])
def test_rotary(dim_head):
    f = 11
    freqs_j = j_rot.rotary_frequencies(f, min(32, dim_head))
    np.testing.assert_array_equal(
        t_rot.rotary_frequencies(f, min(32, dim_head)), freqs_j)
    np.testing.assert_array_equal(
        t_rot.rotary_head_matrices(freqs_j, dim_head),
        j_rot.rotary_head_matrices(freqs_j, dim_head))
    x = _rand((2, f, 3 * dim_head), 5)
    _close(t_rot.apply_rotary_heads(torch.tensor(x), torch.tensor(freqs_j),
                                    3),
           j_rot.apply_rotary_heads(jnp.asarray(x), jnp.asarray(freqs_j), 3))


def test_relative_bias():
    np.testing.assert_array_equal(t_rb.temporal_bucket_table(11),
                                  j_rb.temporal_bucket_table(11))
    table = _rand((32, 8), 6)
    mod = t_emb.RelativePositionBias(heads=8, num_buckets=32, max_distance=32)
    with torch.no_grad():
        mod.relative_attention_bias.weight.copy_(torch.tensor(table))
    want = j_emb.RelativePositionBias(8, 32, 32).apply(
        {"params": {"relative_attention_bias": jnp.asarray(table)}}, 11)
    _close(mod(11), want)


def test_sinusoidal_embedding():
    t = np.array([0, 3, 255], np.int32)
    want = j_emb.SinusoidalPosEmb(16).apply({}, jnp.asarray(t))
    _close(t_emb.SinusoidalPosEmb(16)(torch.tensor(t)), want)


def _hwio_to_oihw(k):
    return torch.tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("ks,stride,padding", [(3, 1, None), (7, 1, None),
                                               (4, 2, 1)])
def test_conv2d_spatial(ks, stride, padding):
    x = _rand((2, 3, 8, 8, 4), 7)
    k, b = _rand((ks, ks, 4, 6), 8, 0.3), _rand((6,), 9)
    want = j_conv.conv2d_spatial(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(b), stride=stride,
                                 padding=padding)
    got = t_conv.conv2d_spatial(torch.tensor(x), _hwio_to_oihw(k),
                                torch.tensor(b), stride=stride,
                                padding=padding)
    _close(got, want)


def test_conv_transpose2d_spatial():
    x = _rand((2, 3, 6, 6, 4), 10)
    k, b = _rand((4, 4, 4, 4), 11, 0.3), _rand((4,), 12)   # forward-oriented
    want = j_conv.conv_transpose2d_spatial(jnp.asarray(x), jnp.asarray(k),
                                           jnp.asarray(b))
    # the torch ConvTranspose weight (I, O, kh, kw) the JAX kernel came from
    w_t = np.ascontiguousarray(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    got = t_conv.conv_transpose2d_spatial(torch.tensor(x),
                                          torch.tensor(w_t), torch.tensor(b))
    assert got.shape == (2, 3, 12, 12, 4)
    _close(got, want)


def test_conv1x1():
    x, k, b = _rand((2, 5, 4), 13), _rand((4, 6), 14), _rand((6,), 15)
    _close(t_conv.conv1x1(torch.tensor(x), torch.tensor(k.T.copy()),
                          torch.tensor(b)),
           j_conv.conv1x1(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))


@pytest.mark.parametrize("n,n_cond", [(11, 0), (11, 1), (80, 1)])
def test_stacked_softmax_attention(n, n_cond):
    """n = 80 takes the JAX function's matmul form (weights rounded to v's
    dtype), n = 11 its broadcast form."""
    b, s, h, d = 2, 3, 2, 8
    m = n + n_cond
    q, k, v = (_rand((b, s, h, n, d), 16), _rand((b, s, h, m, d), 17),
               _rand((b, s, h, m, d), 18))
    kw = dict(scale=d ** -0.5, num_video_tokens=n)
    want = j_att.stacked_softmax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = t_att.stacked_softmax_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    _close(got, want)


def test_linear_attention_tokens_first():
    q, k, v = _rand((3, 16, 2, 8), 20), _rand((3, 17, 2, 8), 21), \
        _rand((3, 17, 2, 8), 22)
    kw = dict(scale=8 ** -0.5, spatial_size=16)
    _close(t_att.linear_attention_tokens_first(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw),
        j_att.linear_attention_tokens_first(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_label_normalization_matches_the_checkpoint_scaling():
    import json
    aux = json.load(open("ckpt_cache/demo4x_step_8000.aux.json"))
    labels = np.abs(_rand((4, 51), 23, 0.1))
    t = t_norm.Normalization.from_dict(aux["labels_scaling"])
    j = j_norm.Normalization.from_dict(aux["labels_scaling"])
    cond_t = t.normalize(t_norm.interpolate_labels(labels, 11))
    np.testing.assert_array_equal(cond_t, j.normalize(j_interp(labels, 11)))
    np.testing.assert_allclose(t.unnormalize(cond_t), j.unnormalize(cond_t))
    for strategy in t_norm.STRATEGIES:
        d = dict(aux["labels_scaling"], strategy=strategy)
        np.testing.assert_allclose(
            t_norm.Normalization.from_dict(d).normalize(cond_t),
            j_norm.Normalization.from_dict(d).normalize(cond_t), rtol=1e-6)
