"""The port's whole-block CLIP kernels in bf16 and fp32: fused_vit_block (the
short fused_block path and the long whole / whole_dd variants) and
fused_attention_block (block_diag; without it in
tests/test_torch_attention_block.py): each plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) in its three softmax
orders, at 5, 50 and 197 tokens and with groups of 1, 2 and 4 images; the
wrappers on CPU tensors; and the CUDA kernels against the plain versions on
the card."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from test_torch_vit_kernels import bf16_ulp_of  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WIDTH, HEADS, D_FF = 64, 4, 256
EPS = 1e-5
# The weights have the CLIP towers' init scale (std 0.02); x, the
# LayerNorms' parameters and the biases are of order 1 and 0.1.
WEIGHT_STD = 0.02
# bf16: every element within one bf16 ulp of JAX's and at least 99.9 % equal
# (both sides round at the same places; fp32 sums in another order, and
# XLA's exp and sigmoid, can move a value across a bf16 rounding boundary).
MIN_EQUAL = 0.999
# fp32 fused_vit_block: its Pallas kernel still rounds h, q, k, v, p, the
# attention output, h2 and the hidden to bf16; one of those roundings that
# goes the other way moves the output by far less than FLIP_TOL (|want| +
# rms(want)) (a bf16 ulp of the intermediate times a 0.02 weight), and
# elsewhere only fp32 sums in another order differ: at least MIN_CLOSE of
# the elements within FP32_TOL (|want| + rms(want)).
FLIP_TOL = 2.0 ** -12
FP32_TOL = 1e-5
MIN_CLOSE = 0.99
MODES = {"normalised": {}, "deferred_div": {"deferred_div": True},
         "fast_exp": {"fast_exp": True}}
BLOCK_KEYS = ("ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v",
              "v_bias", "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
              "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")
ATTN_KEYS = ("q", "q_bias", "k", "k_bias", "v", "v_bias", "o", "o_bias")


def jax_fab():
    pytest.importorskip("jax")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )
    return jfab


def make_inputs(seed=0, batch=4, seq=50):
    """x and one layer's parameters, in the tower's keys, as numpy fp32."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d, f = WIDTH, D_FF
    layer = {"ln1_scale": 1 + normal(d, scale=0.1),
             "ln1_bias": normal(d, scale=0.1),
             "ln2_scale": 1 + normal(d, scale=0.1),
             "ln2_bias": normal(d, scale=0.1),
             "mlp_fc": normal(d, f, scale=WEIGHT_STD),
             "mlp_fc_bias": normal(f, scale=0.1),
             "mlp_proj": normal(f, d, scale=WEIGHT_STD),
             "mlp_proj_bias": normal(d, scale=0.1)}
    for name in ("q", "k", "v", "o"):
        layer[name] = normal(d, d, scale=WEIGHT_STD)
        layer[name + "_bias"] = normal(d, scale=0.1)
    return normal(batch, seq, d), layer


def run_jax(kernel, x, layer, dtype, group, **kw):
    jfab = jax_fab()
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    keys = BLOCK_KEYS if kernel == "fused_vit_block" else ATTN_KEYS
    if kernel == "fused_attention_block":
        kw = dict(kw, block_diag=True)
    out = getattr(jfab, kernel)(
        jnp.asarray(x, jd), *(jnp.asarray(layer[n], jd) for n in keys),
        num_heads=HEADS, group=group, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def port_args(kernel, x, layer, dtype):
    td = TORCH_DTYPES[dtype]
    keys = BLOCK_KEYS if kernel == "fused_vit_block" else ATTN_KEYS
    return (torch.from_numpy(x).to(td),
            *(torch.from_numpy(layer[n]).to(td) for n in keys), HEADS)


def run_port(fn, kernel, x, layer, dtype, **kw):
    if kernel == "fused_attention_block":
        kw = dict(kw, block_diag=True)
    out = fn(*port_args(kernel, x, layer, dtype), **kw)
    assert out.dtype == TORCH_DTYPES[dtype] and tuple(out.shape) == x.shape
    return out.float().numpy()


def assert_close(got, want, dtype, fp32_tol=None):
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= bf16_ulp_of(want)).all(), \
            np.abs(got - want).max()
        assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()
        return
    rel = np.abs(got - want) / (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    if fp32_tol is not None:      # no bf16 rounding inside
        assert rel.max() <= fp32_tol, rel.max()
        return
    assert rel.max() <= FLIP_TOL, rel.max()
    assert (rel <= FP32_TOL).mean() >= MIN_CLOSE, (rel <= FP32_TOL).mean()


# --- fused_vit_block ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_pallas_kernel(mode, dtype):
    """50 tokens (ViT-B/32's length), 4 images in JAX's group of 4."""
    x, layer = make_inputs()
    want = run_jax("fused_vit_block", x, layer, dtype, 4, **MODES[mode])
    got = run_port(tfab.fused_vit_block_plain, "fused_vit_block", x, layer,
                   dtype, **MODES[mode])
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_group_changes_only_the_order_of_sums(group, dtype):
    """5 tokens: JAX's kernel at each group (its cross-image scores add
    exact zeros) against the port's image-by-image plain version."""
    x, layer = make_inputs(seed=1, seq=5)
    want = run_jax("fused_vit_block", x, layer, dtype, group)
    got = run_port(tfab.fused_vit_block_plain, "fused_vit_block", x, layer,
                   dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["whole", "whole_dd"])
def test_long_whole_variants_match_pallas_kernel(variant, dtype):
    """197 tokens at group 1, as models/clip.py's whole / whole_dd call
    the kernel."""
    x, layer = make_inputs(seed=2, batch=1, seq=197)
    kw = {"deferred_div": variant == "whole_dd"}
    want = run_jax("fused_vit_block", x, layer, dtype, 1, **kw)
    got = run_port(tfab.fused_vit_block, "fused_vit_block", x, layer, dtype,
                   group=1, **kw)
    assert_close(got, want, dtype)


def test_fast_exp_wins_over_deferred_div():
    """The Pallas kernel checks fast_exp first; so does the port."""
    x, layer = make_inputs(seed=3, batch=2, seq=5)
    both = run_port(tfab.fused_vit_block_plain, "fused_vit_block", x, layer,
                    "float32", fast_exp=True, deferred_div=True)
    fast = run_port(tfab.fused_vit_block_plain, "fused_vit_block", x, layer,
                    "float32", fast_exp=True)
    np.testing.assert_array_equal(both, fast)


def test_softmax_orders_differ_in_fp32():
    """The three orders round at other places: in fp32 each output moves
    by far more than fp32 noise from the others."""
    x, layer = make_inputs(seed=4, batch=2)
    outs = [run_port(tfab.fused_vit_block_plain, "fused_vit_block", x, layer,
                     "float32", **kw) for kw in MODES.values()]
    for i in range(3):
        for j in range(i):
            assert np.abs(outs[i] - outs[j]).max() > 1e-5


# --- fused_attention_block ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seq", [5, 50])
def test_attention_block_plain_matches_pallas_kernel(seq, dtype):
    """Everything is fp32 inside the block-diagonal kernel: in fp32 only the
    order of the sums differs."""
    x, layer = make_inputs(seed=5, seq=seq)
    want = run_jax("fused_attention_block", x, layer, dtype, 4)
    got = run_port(tfab.fused_attention_block_plain, "fused_attention_block",
                   x, layer, dtype)
    assert_close(got, want, dtype, fp32_tol=FP32_TOL)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_block_group_changes_only_the_order_of_sums(group):
    x, layer = make_inputs(seed=6)
    want = run_jax("fused_attention_block", x, layer, "float32", group)
    got = run_port(tfab.fused_attention_block, "fused_attention_block", x,
                   layer, "float32", group=group)
    assert_close(got, want, "float32", fp32_tol=FP32_TOL)


# --- the wrappers on the CPU ------------------------------------------------

@pytest.mark.parametrize("kernel", ["fused_vit_block",
                                    "fused_attention_block"])
def test_wrapper_takes_plain_version_on_cpu(kernel):
    x, layer = make_inputs(seed=8, seq=5)
    fn = getattr(tfab, kernel)
    before = fn.launches
    got = run_port(fn, kernel, x, layer, "bfloat16", group=4)
    want = run_port(getattr(tfab, kernel + "_plain"), kernel, x, layer,
                    "bfloat16")
    np.testing.assert_array_equal(got, want)
    assert fn.launches == before


@pytest.mark.parametrize("kernel", ["fused_vit_block",
                                    "fused_attention_block"])
def test_wrapper_checks_the_group(kernel):
    x, layer = make_inputs(seed=9, batch=3, seq=5)
    kw = {"block_diag": True} if kernel == "fused_attention_block" else {}
    with pytest.raises(ValueError, match="group"):
        getattr(tfab, kernel)(*port_args(kernel, x, layer, "float32"),
                              group=2, **kw)


# --- on the card: the CUDA kernels against the plain versions --------------

def cuda_layer(cfg, batch):
    """x and one layer of ``cfg``'s widths on the card, bf16: init-scale
    weights, random LayerNorm parameters and biases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = {name: leaf[0] for name, leaf in tclip.init_clip_vision_params(
        gen, cfg)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            noise = torch.randn(leaf.shape, generator=gen, device="cuda")
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * noise).bfloat16()
    x = torch.randn((batch, cfg.seq_len, cfg.width), generator=gen,
                    device="cuda").bfloat16()
    return x, layer


def assert_kernel_close(got, want):
    """Every element within one bf16 ulp of the plain version's, or 8e-3
    (1 + |want|) where a rounding near a boundary went the other way."""
    g, p = got.float(), want.float()
    err = (g - p).abs()
    assert bool(torch.isfinite(g).all())
    assert bool((err <= 8e-3 * (1 + p.abs())).all()), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES) + ["whole", "whole_dd"])
def test_cuda_fused_vit_block_matches_plain_version(mode):
    """ViT-B/32 widths on 8 images in each softmax order; ViT-L/14@336's
    577 tokens on 2 images for the long variants. One launch counted, and
    float16 inputs refused (fp32 ones take the fp32 form:
    tests/test_torch_vit_whole_f32.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    long = mode.startswith("whole")
    cfg = (tclip.CLIPVisionConfig.vit_l_14_336() if long
           else tclip.CLIPVisionConfig.vit_b_32())
    x, layer = cuda_layer(cfg, 2 if long else 8)
    args = (x, *(layer[n] for n in BLOCK_KEYS), cfg.num_heads)
    kw = {"deferred_div": mode == "whole_dd"} if long else MODES[mode]
    group = 1 if long else 4
    before = tfab.fused_vit_block.launches
    got = tfab.fused_vit_block(*args, group=group, **kw)
    torch.cuda.synchronize()
    assert tfab.fused_vit_block.launches == before + 1
    assert_kernel_close(got, tfab.fused_vit_block_plain(*args, **kw))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfab.fused_vit_block(x.half(), *args[1:], group=group, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [6, 3])
def test_cuda_fused_vit_block_ragged_rows(batch):
    """ViT-B/32 widths on 6 and 3 images (300 and 150 rows: the last row
    band of every product, the fp32 r1's among them, ends inside a 64-row
    store box): within the whole-block rule of the plain version, and bit
    for bit the rows of the same images in a batch of 16, so no box wrote
    past its rows and no row depends on the others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tclip.CLIPVisionConfig.vit_b_32()
    x, layer = cuda_layer(cfg, 16)
    params = [layer[n] for n in BLOCK_KEYS]
    whole = tfab.fused_vit_block(x, *params, cfg.num_heads, group=1)
    part = x[:batch].contiguous()
    got = tfab.fused_vit_block(part, *params, cfg.num_heads, group=1)
    torch.cuda.synchronize()
    assert torch.equal(got, whole[:batch])
    assert_kernel_close(got, tfab.fused_vit_block_plain(part, *params,
                                                        cfg.num_heads))


@pytest.mark.gpu
def test_cuda_fused_attention_block_matches_plain_version():
    """ViT-B/32 widths on 8 images: within one bf16 ulp of the fp32 plain
    version's output (the kernel's products are exact, its sums in another
    order: neighbouring bf16 values, the ulp of the larger where they lie
    on either side of a power of two, and at least that of rms / 256 for
    outputs near zero, where fp32 noise is many of their ulps), one launch
    counted, and float16 inputs refused (fp32 ones take the fp32 forms:
    tests/test_torch_vit_whole_f32.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tclip.CLIPVisionConfig.vit_b_32()
    x, layer = cuda_layer(cfg, 8)
    args = (x, *(layer[n] for n in ATTN_KEYS), cfg.num_heads)
    before = tfab.fused_attention_block.launches
    got = tfab.fused_attention_block(*args, group=4, block_diag=True)
    torch.cuda.synchronize()
    assert tfab.fused_attention_block.launches == before + 1
    got = got.float().cpu().numpy()
    want = tfab.fused_attention_block_plain(*args, block_diag=True).float() \
        .cpu().numpy()
    floor = np.sqrt(np.mean(want ** 2)) / 256
    ulp = bf16_ulp_of(np.maximum(np.maximum(np.abs(got), np.abs(want)), floor))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfab.fused_attention_block(x.half(), *args[1:], group=4,
                                   block_diag=True)
