"""PyTorch port, the conditioning ablations and model variants on the CPU:
the UNet3D of each variant (whole-curve CNN tokens, GRU tokens, no
tokens, cross-attention, 'concat' time conditioning, no spatial linear
attention, the circular padding modes) against the JAX UNet3D on weights
bridged from the same flax tree, both plans; the temporal kernels' twins
(table rows 1-3) at the ablations' token counts against the JAX package's
XLA reference, its emit_p kernel in interpret mode and jax.vjp; a guided
CFG step of the CNN arm against the JAX GaussianDiffusion; the GRU weight
split both ways; the reference checkpoint import of the embedders against
the JAX importer composed with convert; the padding modes and the
position bias of the attention core against the JAX functions; and the
whole-curve conditioning of the entry points. The CUDA kernels are held
against the same twins on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 9)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.data.normalization import (
    Normalization as JNormalization,
)
from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.models.embeddings import (
    SignalEmbedding as JSignalEmbedding,
)
from videometamaterials_tpu.ops.attention import (
    stacked_softmax_attention as j_attention,
)
from videometamaterials_tpu.ops.conv import (
    conv2d_spatial as j_conv,
    conv_transpose2d_spatial as j_conv_t,
)
from videometamaterials_tpu.ops.pallas.fused_temporal_block import (
    _run_kernel as j_run_kernel,
    reference_temporal_block,
)
from videometamaterials_tpu.training.torch_import import (
    import_state_dict as j_import,
)
from videometamaterials_tpu_torch import config
from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    gru_flax_to_torch,
    gru_torch_to_flax,
    torch_to_flax_tree,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.embeddings import SignalEmbedding
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.ops.attention import (
    stacked_softmax_attention,
)
from videometamaterials_tpu_torch.ops.conv import (
    conv2d_spatial,
    conv_transpose2d_spatial,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as t_tmp
from videometamaterials_tpu_torch.sample import target_cond
from videometamaterials_tpu_torch.training import torch_import

torch.set_num_threads(1)

FRAMES, IMG, CURVE = 11, 16, 50
TINY = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=4, init_kernel_size=3,
            use_temporal_attention_cond=True)
CNN16 = dict(per_frame_cond=False, cond_attention="self-stacked",
             cond_attention_tokens=16)
VARIANTS = {
    "cnn16": CNN16,
    "gru": dict(CNN16, cond_att_GRU=True),
    "none": dict(per_frame_cond=False, cond_attention="none"),
    "cross": dict(per_frame_cond=False, cond_attention="cross-attention",
                  cond_attention_tokens=16),
    "concat": dict(CNN16, cond_to_time="concat"),
    "no_sparse": dict(per_frame_cond=True, use_sparse_linear_attn=False),
    "circular": dict(per_frame_cond=True, padding_mode="circular"),
    "circular_1d": dict(per_frame_cond=True, padding_mode="circular_1d"),
}
# float32 on both sides: the plans differ from the JAX model in summation
# order (convolutions, norms, attention), and the fused twins in the
# two-pass LN and the +-60 clamp of the linear keys (exact here)
F32_SHARE = 1e-4
# bf16 operands: the twins and the JAX reference round in different
# places -- the JAX kernel test's tolerance (tests/test_fused_temporal_block.py:50)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# backward: each cotangent within 5e-2 of the oracle's largest |element|
# (the JAX rule for its backward kernels, tests/test_fused_temporal_block.py:277)
GRAD_SHARE = 5e-2


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _cond_width(kw):
    return FRAMES if kw.get("per_frame_cond", True) else CURVE


def _random_params(model, args, seed):
    """A random parameter tree of the JAX model's structure (eval_shape:
    no init run): LeCun-scaled kernels, norm scales near 1 and biases near
    0 but not equal, so the comparison sees every parameter."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2:
            return noise / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        base = 1.0 if name in ("scale", "gn_scale", "norm_gamma") else 0.0
        return np.float32(base) + np.float32(0.05) * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _max_share(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ----------------------------------------------------------- the model


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """(name, kwargs, flax params, inputs, the JAX model's eps)."""
    kw = VARIANTS[request.param]
    j_model = JUNet3D(compute_dtype="float32", **TINY, **kw)
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    time = np.array([3, 250], np.int32)
    cond = np.random.default_rng(1).uniform(
        -1, 1, (2, _cond_width(kw))).astype(np.float32)
    mask = np.array([False, True])
    params = _random_params(j_model, (x, time, cond), 2)
    apply = jax.jit(lambda p, *a: j_model.apply(p, *a[:3],
                                                null_cond_mask=a[3]))
    want = np.asarray(apply(params, x, time, cond, mask))
    return request.param, kw, params, (x, time, cond, mask), want


def _port(kw, params, fused):
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                   use_fused_linear_block=fused,
                   use_fused_temporal_block=fused, cond_length=CURVE, **TINY,
                   **kw)
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("fused", [False, "all"])
def test_variant_forward_matches_jax(variant, fused):
    name, kw, params, (x, time, cond, mask), want = variant
    model = _port(kw, params, fused)
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(time), torch.tensor(cond),
                    null_cond_mask=torch.tensor(mask)).numpy()
    assert got.shape == want.shape
    assert _max_share(got, want) <= F32_SHARE, name
    # the state dict goes back to the same flax tree
    back = torch_to_flax_tree(model.state_dict())["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_allclose(leaf, flat[path], rtol=0, atol=1e-7)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))


def test_variant_modules_follow_the_jax_model():
    """Which modules each variant builds: the embedders, the null token's
    length, to_q only under cross-attention, no to_k/to_v under 'none',
    the fused plan off where it has no form."""
    def build(**kw):
        return UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                      cond_length=CURVE, **TINY, **kw)

    keys = set(build(**CNN16).state_dict())
    assert "sign_emb_CNN.emb_model.8.weight" in keys
    assert not any(k.startswith(("sign_emb.", "sign_emb_GRU.")) for k in keys)
    assert build(**CNN16).null_text_token.shape == (1, 16, 32)
    assert build(**VARIANTS["gru"]).null_text_token.shape == (1, CURVE, 32)
    none = build(**VARIANTS["none"])
    assert not hasattr(none, "null_text_token")
    assert not any(".to_k." in k or ".to_v." in k for k in none.state_dict())
    cross = build(**VARIANTS["cross"])
    assert "downs.0.2.fn.fn.to_q.weight" in cross.state_dict()
    assert "downs.0.3.fn.fn.fn.to_q.weight" in cross.state_dict()
    assert not any(m.use_fused_block for m in (cross.downs[0][2],
                                               cross.downs[0][3]))
    # per-frame conditioning forces self-stacked tokens, one a frame
    forced = build(per_frame_cond=True, cond_attention="none")
    assert forced.cond_attention == "self-stacked"
    assert forced.null_text_token.shape == (1, FRAMES, 32)


def test_token_count_above_the_kernels_raises_when_built(monkeypatch):
    """Any token count builds, runs and trains on the fused plans: above
    MAX_COND_TOKENS the any-shape instances of rows 1-3 take the count, so
    the training plans that launch the temporal training kernels (the
    'kernel' and 'saved' backward plans, VMT_TEMPORAL_BWD_KERNEL=1) give
    the recompute plan's gradients: within 1e-4 of each one's max plus
    1e-6 of the model's largest, float32 noise (the saved plan's backward
    takes the one-pass LN; a conv bias ahead of a GroupNorm has a gradient
    that is float cancellation only, ~1e-6 of the largest; the unfused
    plan is as far from the recompute one). (The name dates from
    when the model refused the count at build, and then the training plans'
    forward.)"""
    over = t_tmp.MAX_COND_TOKENS + 1
    kw = dict(compute_dtype=torch.float32, **TINY, per_frame_cond=False,
              cond_attention_tokens=over)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-1, 1, (1, FRAMES, IMG, IMG, 3)),
                     dtype=torch.float32)
    time = torch.tensor([5])
    cond = torch.tensor(rng.uniform(-1, 1, (1, CURVE)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)

    def grads(**plan):
        model = UNet3D(**kw, **plan)
        model.init_weights(torch.Generator().manual_seed(0))
        out = model(x, time, cond)
        assert torch.isfinite(out).all()
        out.backward(g)
        return {n: p.grad for n, p in model.named_parameters()
                if p.grad is not None}

    want = grads()                               # 'recompute'
    plans = [dict(fused_bwd_kernels=True), dict(temporal_vjp="saved"), {}]
    for i, plan in enumerate(plans):
        if i == 2:
            monkeypatch.setenv("VMT_TEMPORAL_BWD_KERNEL", "1")
        got = grads(**plan)
        assert got.keys() == want.keys()
        largest = max(w.abs().max().item() for w in want.values())
        for n, w in want.items():
            bound = 1e-4 * w.abs().max().item() + 1e-6 * largest
            assert (got[n] - w).abs().max().item() <= bound, n
    with torch.no_grad():                        # sampling takes any plan
        UNet3D(**kw, fused_bwd_kernels=True)(x, time, cond)
    # the unfused plans take any count; so does the GRU's own width
    UNet3D(**kw, use_fused_temporal_block=False)(x, time, cond)
    UNet3D(compute_dtype=torch.float32, **TINY, per_frame_cond=False,
           cond_att_GRU=True, cond_length=t_tmp.MAX_COND_TOKENS)


def test_guided_steps_of_the_cnn_arm_match_jax():
    """Two guided DDPM steps (w = 5, bisect dynamic thresholding) of the
    CNN-16 arm through p_mean_variance against p_sample on the fused plans,
    with the same x_T and noise."""
    T = 16
    diff = dict(image_size=IMG, num_frames=FRAMES, channels=3, timesteps=T,
                use_dynamic_thres=True)
    j_model = JUNet3D(compute_dtype="float32", **TINY, **CNN16)
    b, w = 2, 5.0
    shape = (b, FRAMES, IMG, IMG, 3)
    cond = np.random.default_rng(1).uniform(-1, 1, (b, CURVE)).astype(
        np.float32)
    params = _random_params(j_model, (np.zeros(shape, np.float32),
                                      np.zeros((b,), np.int32), cond), 3)
    j_diff = JDiffusion(model=j_model, **diff)
    t_diff = GaussianDiffusion(_port(CNN16, params, "all"), **diff)
    pmv = jax.jit(lambda p, x, t, c: j_diff.p_mean_variance(p, x, t, c, w))
    x_t = _rand(shape, 2)
    j_img, t_img = jnp.asarray(x_t), torch.tensor(x_t)
    for i in range(2):
        noise = _rand(shape, 10 + i)
        t_scalar = T - 1 - i
        mean, _, log_var = pmv(params, j_img, jnp.full((b,), t_scalar),
                               jnp.asarray(cond))
        j_img = mean + jnp.exp(0.5 * log_var) * noise
        with torch.no_grad():
            t_img = t_diff.p_sample(t_img, torch.full((b,), t_scalar),
                                    torch.tensor(cond), w,
                                    torch.tensor(noise))
        # the step scales the model's float32 error by the posterior
        # coefficients (tests/test_torch_port_sampler.py's bound)
        np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img),
                                   rtol=1e-3, atol=1e-3, err_msg=f"step {i}")


# ------------------------------------------- the temporal kernels' twins

B, F, S, C = 2, 5, 256, 8
HEADS, D = 4, 32
HD = HEADS * D
T_NAMES = ("dx", "dgamma", "dw_all", "dw_out", "dek", "dev", "dbias")
ABLATION_T = (6, 16, 50)


def _temporal_args(n_cond):
    return (_rand((B, F, S, C), 0), _rand((C,), 1, 0.2) + 1.0,
            _rand((F, C, 3 * HD), 2, 0.1), _rand((HD, C), 3, 0.1),
            _rand((B, n_cond, HD), 5, 0.5), _rand((B, n_cond, HD), 6, 0.5),
            _rand((F, F + n_cond, HEADS), 7, 0.3))


def _jax_bf16(args):
    x, gamma, w_all, w_out, ek, ev, bias = args
    bf = jnp.bfloat16
    return [jnp.asarray(x, bf), jnp.asarray(gamma), jnp.asarray(w_all, bf),
            jnp.asarray(w_out, bf), jnp.asarray(ek, bf), jnp.asarray(ev, bf),
            jnp.asarray(bias)]


def _torch_bf16(args):
    x, gamma, w_all, w_out, ek, ev, bias = args
    bf = torch.bfloat16
    return [torch.tensor(x).to(bf), torch.tensor(gamma),
            torch.tensor(w_all).to(bf), torch.tensor(w_out).to(bf),
            torch.tensor(ek).to(bf), torch.tensor(ev).to(bf),
            torch.tensor(bias)]


@pytest.mark.parametrize("n_cond", ABLATION_T)
def test_temporal_twins_at_the_ablation_token_counts(n_cond):
    """Row 1 (the wrapper on CPU tensors) against the JAX XLA reference,
    row 2's (out, p) against the JAX merged kernel with emit_p in interpret
    mode, and row 3 against jax.vjp of the reference."""
    args = _temporal_args(n_cond)
    t_args = _torch_bf16(args)
    before = dict(_build.LAUNCH_COUNTS)
    out = t_tmp.fused_temporal_block(*t_args, heads=HEADS)
    out_p, p = t_tmp.temporal_block_fwd(*t_args, heads=HEADS, emit_p=True)
    g = _rand((B, F, S, C), 8)
    got = t_tmp.temporal_block_bwd(*t_args, torch.tensor(g).to(torch.bfloat16),
                                   heads=HEADS)
    assert _build.LAUNCH_COUNTS == before      # CPU tensors: the twins ran

    j_args = _jax_bf16(args)

    def ref(*a):
        return reference_temporal_block(*a, heads=HEADS)

    want = jax.jit(ref)(*j_args)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    assert torch.equal(out_p, out)
    if n_cond == 16:          # one count through the interpret-mode kernel
        want_out, want_p = j_run_kernel(*j_args, heads=HEADS, tile=128,
                                        interpret=True,
                                        softmax_layout="merged", emit_p=True)
        np.testing.assert_allclose(out_p.float().numpy(),
                                   np.asarray(want_out, np.float32),
                                   **BF16_TOL)
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(want_p, np.float32), **BF16_TOL)
    assert tuple(p.shape) == (B, F, S, (F + n_cond) * HEADS)
    sums = p.float().reshape(B, F, S, F + n_cond, HEADS).sum(dim=3)
    torch.testing.assert_close(sums, torch.ones_like(sums), rtol=0,
                               atol=2.0 ** -7)

    cotangents = jax.jit(lambda a, g_: jax.vjp(ref, *a)[1](g_))(
        j_args, jnp.asarray(g, jnp.bfloat16))
    for name, a, b in zip(T_NAMES, got, cotangents):
        b32 = np.asarray(b, np.float32)
        assert _max_share(a.float().numpy(), b32) <= GRAD_SHARE, name
        assert np.abs(a.float().numpy()).max() > 0, name


def test_temporal_wrapper_refuses_a_count_above_the_kernels():
    with pytest.raises(ValueError, match="0 to 69"):
        t_tmp.check_cond_tokens(t_tmp.MAX_COND_TOKENS + 1)
    t_tmp.check_cond_tokens(t_tmp.MAX_COND_TOKENS)
    assert t_tmp.MAX_COND_TOKENS + t_tmp.FRAMES == 80


# ------------------------------------------------------------- pieces


@pytest.mark.parametrize("mode", ["circular", "circular_1d", "zeros"])
def test_padding_modes_match_jax(mode):
    """SpatialConv (odd and stride-2 kernels) and the transposed conv in
    each padding mode against the JAX ops/conv.py, float32."""
    x = _rand((2, 3, 8, 8, 4), 0)
    for k, stride, pad in ((3, 1, None), (4, 2, 1), (7, 1, None)):
        w = _rand((k, k, 4, 5), 1, 0.3)                  # HWIO
        b = _rand((5,), 2, 0.1)
        want = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=stride, padding=pad, padding_mode=mode)
        got = conv2d_spatial(torch.tensor(x),
                             torch.tensor(w.transpose(3, 2, 0, 1)),
                             torch.tensor(b), stride=stride, padding=pad,
                             padding_mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(k))
    w = _rand((4, 4, 4, 4), 3, 0.3)          # forward-conv orientation
    b = _rand((4,), 4, 0.1)
    want = j_conv_t(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    padding_mode=mode)
    # the JAX kernel is the flipped forward one: the ConvTranspose weight
    w_t = w[::-1, ::-1].transpose(2, 3, 0, 1).copy()     # (I, O, kh, kw)
    got = conv_transpose2d_spatial(torch.tensor(x), torch.tensor(w_t),
                                   torch.tensor(b), padding_mode=mode)
    assert got.shape == (2, 3, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_cond,on_cond", [(0, False), (5, True), (7, False)])
def test_attention_core_position_bias_matches_jax(n_cond, on_cond):
    """stacked_softmax_attention with the position bias on the video block
    (and on the per-frame cond block), and keys shared by every s."""
    b, s, h, n, d = 2, 3, 2, 5, 4
    q = _rand((b, s, h, n, d), 0)
    k = _rand((b, s, h, n_cond + n, d), 1)
    v = _rand((b, s, h, n_cond + n, d), 2)
    bias = _rand((h, n, n), 3)
    kw = dict(scale=d ** -0.5, num_video_tokens=n)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       pos_bias=jnp.asarray(bias), pos_bias_on_cond=on_cond,
                       **kw)
    got = stacked_softmax_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v),
                                    pos_bias=torch.tensor(bias),
                                    pos_bias_on_cond=on_cond, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # cross-attention: the tokens' keys shared by every s, never copied
    kc, vc = k[:, :1, :, :n_cond or 3], v[:, :1, :, :n_cond or 3]
    want = j_attention(jnp.asarray(q), jnp.broadcast_to(kc, (b, s) + kc.shape[2:]),
                       jnp.broadcast_to(vc, (b, s) + vc.shape[2:]), **kw)
    got = stacked_softmax_attention(torch.tensor(q), torch.tensor(kc),
                                    torch.tensor(vc), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the focus-present mask: defined on unstacked keys only (the JAX
    # assert), where it matches the JAX core
    mask = np.array([True, False])
    if n_cond:
        with pytest.raises(ValueError, match="unstacked"):
            stacked_softmax_attention(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v),
                                      focus_present_mask=torch.tensor(mask),
                                      **kw)
    else:
        want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           pos_bias=jnp.asarray(bias),
                           focus_present_mask=jnp.asarray(mask), **kw)
        got = stacked_softmax_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            pos_bias=torch.tensor(bias),
            focus_present_mask=torch.tensor(mask), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _gru_leaves(seed, hidden=6, features=1):
    rng = np.random.default_rng(seed)
    leaves = {}
    for k in range(3):
        cell = ("sign_emb_GRU", f"gru_cell_{k}")
        fin = features if k == 0 else hidden
        for gate in ("ir", "iz", "in"):
            leaves[cell + (gate, "kernel")] = rng.standard_normal(
                (fin, hidden)).astype(np.float32) * 0.5
        for gate in ("hr", "hz", "hn"):
            leaves[cell + (gate, "kernel")] = rng.standard_normal(
                (hidden, hidden)).astype(np.float32) * 0.5
        for gate in ("ir", "iz", "in", "hn"):
            leaves[cell + (gate, "bias")] = rng.standard_normal(
                hidden).astype(np.float32) * 0.2
    return leaves


def _tree(leaves):
    tree = {}
    for path, arr in leaves.items():
        node = tree
        for name in path[1:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
    return tree


def test_gru_weight_split_both_ways():
    """flax GRUCell leaves -> nn.GRU (fused r/z biases in bias_ih, zeros in
    bias_hh's r and z thirds) gives the JAX GRU's sequence; an nn.GRU with
    nonzero hidden r/z biases -> flax leaves gives the torch GRU's."""
    hidden, x = 6, _rand((2, CURVE), 0)
    j_gru = JSignalEmbedding("GRU", channel_upsamplings=(4, 4, 4, 4, hidden))
    t_gru = SignalEmbedding("GRU", 1, (4, 4, 4, 4, hidden))

    leaves = _gru_leaves(1, hidden)
    state = {}
    for k in range(3):
        state.update({n.split("sign_emb_GRU.")[1]: torch.tensor(a)
                      for n, a in gru_flax_to_torch(leaves, k).items()})
    for k in range(3):
        assert not state[f"emb_model.bias_hh_l{k}"][:2 * hidden].any()
    t_gru.load_state_dict(state, strict=True)
    want = j_gru.apply({"params": _tree(leaves)}, jnp.asarray(x))
    with torch.no_grad():
        got = t_gru(torch.tensor(x))
    assert got.shape == (2, CURVE, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    torch.manual_seed(0)
    other = SignalEmbedding("GRU", 1, (4, 4, 4, 4, hidden))  # torch's init
    named = {f"sign_emb_GRU.{n}": t.detach().numpy()
             for n, t in other.state_dict().items()}
    assert np.abs(named["sign_emb_GRU.emb_model.bias_hh_l0"][:hidden]).max() > 0
    back = {}
    for k in range(3):
        back.update(gru_torch_to_flax(named, k))
    want = j_gru.apply({"params": _tree(back)}, jnp.asarray(x))
    with torch.no_grad():
        got = other(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and back again: flax -> torch -> flax is exact
    again = {}
    for k in range(3):
        again.update(gru_torch_to_flax(gru_flax_to_torch(leaves, k), k))
    for path, arr in leaves.items():
        np.testing.assert_array_equal(again[path], arr)


def test_reference_import_of_the_embedders_matches_the_jax_importer():
    """A reference-named state dict of the GRU arm (`denoise_fn.` keys,
    sign_emb_CNN.* and sign_emb_GRU.* with nonzero hidden biases) through
    the port's importer and through the JAX importer composed with
    convert: equal tensors, the GRU's r and z biases equal as sums."""
    kw = VARIANTS["gru"]
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                   cond_length=CURVE, **TINY, **kw)
    rng = np.random.default_rng(4)
    ref = {f"denoise_fn.{k}": rng.standard_normal(v.shape).astype(np.float32)
           for k, v in model.state_dict().items()}
    got = torch_import.import_state_dict(
        {k: torch.tensor(v) for k, v in ref.items()}, model.state_dict())

    j_model = JUNet3D(compute_dtype="float32", **TINY, **kw)
    shapes = jax.eval_shape(
        j_model.init, jax.random.PRNGKey(0),
        np.zeros((1, FRAMES, IMG, IMG, 3), np.float32),
        np.zeros((1,), np.int32), np.zeros((1, CURVE), np.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = flax_to_torch_state_dict(j_import(ref, template,
                                             num_resolutions=2))
    assert got.keys() == want.keys()
    h = 32
    for key in got:
        if "emb_model.bias_" in key and key.startswith("sign_emb_GRU"):
            continue
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    for k in range(3):
        pre = "sign_emb_GRU.emb_model."
        g_sum = got[f"{pre}bias_ih_l{k}"] + got[f"{pre}bias_hh_l{k}"]
        w_sum = want[f"{pre}bias_ih_l{k}"] + want[f"{pre}bias_hh_l{k}"]
        torch.testing.assert_close(g_sum[:2 * h], w_sum[:2 * h])
        for name in ("bias_ih", "bias_hh"):
            torch.testing.assert_close(got[f"{pre}{name}_l{k}"][2 * h:],
                                       want[f"{pre}{name}_l{k}"][2 * h:],
                                       rtol=0, atol=0)


def test_whole_curve_conditioning_of_the_entry_points(tmp_path):
    """sample.target_cond takes the curve's tail under per_frame_cond:
    false (the JAX Trainer's eval_target), the per-frame interpolation
    otherwise; the config carries the ablation keys through model.yaml."""
    curves = np.stack([np.linspace(0, -1.2, 51), np.linspace(0, -0.6, 51)])
    csv = tmp_path / "targets.csv"
    np.savetxt(csv, curves, delimiter=",")
    norm = JNormalization.fit(curves[:, 1:])
    got = target_cond(csv, norm.to_dict(), FRAMES, per_frame_cond=False)
    np.testing.assert_allclose(got, np.asarray(norm.normalize(
        curves[:, 1:].astype(np.float32))), rtol=1e-6, atol=1e-6)
    assert target_cond(csv, norm.to_dict(), FRAMES).shape == (2, FRAMES)

    path = tmp_path / "ablation.yaml"
    cfg = config.ModelConfig(per_frame_cond=False, unet_cond_att_GRU=True,
                             unet_cond_attention_tokens=16)
    config.save_model_yaml(cfg, path)
    back = config.load_model_yaml(path)
    assert back == cfg and back.cond_length == CURVE
    raw = config.load_yaml(path.read_text())
    for key in ("unet_cond_attention", "unet_cond_attention_tokens",
                "unet_cond_att_GRU"):
        assert raw[key] == getattr(cfg, key)
    model = UNet3D.from_config(back.replace(unet_dim=8, dim_mults=(1, 2),
                                            compute_dtype="float32"))
    assert model.num_tokens == CURVE and model.cond_att_GRU
    # the training-side keys round-trip with the ablation's (they raised
    # until ROADMAP.md Queue 1 item 8 was ported)
    path.write_text(path.read_text().replace("remat_blocks: false",
                                             "remat_blocks: true"))
    remat = config.load_model_yaml(path)
    assert remat == cfg.replace(remat_blocks=True)
    assert UNet3D.from_config(remat.replace(
        unet_dim=8, dim_mults=(1, 2), compute_dtype="float32")).remat_blocks
    with pytest.raises(ValueError, match="cond_attention"):
        dataclasses.replace(cfg, unet_cond_attention="stacked")

