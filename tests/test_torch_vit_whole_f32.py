"""The fp32 forms of the CLIP whole-block kernels and of flash_attention:
fused_vit_block (fp32 x and / or fp32 LayerNorms and biases; the short
fused_block path and the long whole / whole_dd variants),
fused_attention_block (fp32 x and / or weights, both chains, at any length:
its fp32 attention past 128 tokens on csrc/attention_f32.cuh) and
flash_attention (fp32 q, k, v; use_pallas). On the CPU: the form and route
each CUDA call launches (a recording launcher on meta tensors), the tower in
fp32 reaching each form, fused_attention_block's plain version against the
JAX package's Pallas kernel (interpret mode) past 128 tokens, and the rules
that hold the forms on the card failing every form that rounds x, the
weights or the output to bf16 (mutants of the plain versions). On the card:
each form against its plain version, TF32 off."""

import dataclasses

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import attention as tattn
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from test_torch_vit_f32_kernels import FORMS

F32, BF16 = torch.float32, torch.bfloat16
# fused_attention_block and flash_attention in fp32: every output within
# F32_TOL (1 + |want|) of the plain version (their products are exact, the
# sums in another order). fused_vit_block rounds h, q, k, v, the attention
# output, h2 and the hidden to bf16 in every form, and on the card (the
# tensor cores' truncating sums) about 0.1 % of q, k, v, 1 % of the
# attention output and of h2 and 6-8 % of the hidden round the other way
# from the plain version's, in its bf16 form as in its fp32 ones: a relative
# Frobenius error of 2.5e-4 (ViT-B/32) to 4.7e-4 (ViT-L/14@336) on an H100,
# every element off. Its fp32 rule is against its bf16 form with casts
# around it (x rounded to bf16 in, the output widened), on the same inputs
# and card: a relative Frobenius error of at most BLOCK_VS_BF16 of that
# form's, which a form rounding x or its output to bf16 (about 0.7 of it)
# fails.
F32_TOL = 1e-5
BLOCK_VS_BF16 = 0.5
# bf16 outputs, or fp32 ones through a bf16 chain: within BF16_TOL (1 +
# |want|) (the bf16 forms' rule)
BF16_TOL = 8e-3
WEIGHT_STD = 0.02          # the towers' init scale
# the H100's longest sequence for the whole blocks' attention at head size
# 64 (csrc/vit_attention.cuh's max_len over 232,448 bytes a block)
H100_VIT_MAX_LEN = 1664
BLOCK_VECS = ("ln1_scale", "ln1_bias", "q_bias", "k_bias", "v_bias",
              "o_bias", "ln2_scale", "ln2_bias", "mlp_fc_bias",
              "mlp_proj_bias")
BLOCK_KEYS = ("ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v",
              "v_bias", "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
              "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")
ATTN_KEYS = ("q", "q_bias", "k", "k_bias", "v", "v_bias", "o", "o_bias")


def exact_rule(got, want):
    """(held, figures): every output within F32_TOL (1 + |want|)."""
    err = (got.double() - want.double()).abs()
    limit = F32_TOL * (1 + want.double().abs())
    return bool((err <= limit).all()), dict(max_abs_err=err.max().item())


def rel_frobenius(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def block_rule(got, want, bf16_form):
    """(held, figures): fused_vit_block's fp32 rule (see BLOCK_VS_BF16),
    ``bf16_form`` its bf16 form's output on x rounded to bf16."""
    rel, base = rel_frobenius(got, want), rel_frobenius(bf16_form, want)
    return rel <= BLOCK_VS_BF16 * base, dict(rel_frobenius=rel,
                                             bf16_form_rel_frobenius=base)


def bf16(t):
    return t.to(BF16).to(t.dtype)


def block_layer(width, heads, act, vec, mat, batch, seq, device="cpu",
                seed=0):
    """x (B, L, D) of dtype act and one layer's parameters at the towers'
    init scale (LayerNorm parameters near 1, biases of 0.1): the vectors of
    dtype vec, the weights of mat."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    d_ff = 4 * width
    layer = {}
    for name in BLOCK_VECS:
        n = d_ff if name == "mlp_fc_bias" else width
        base = 1.0 if name.endswith("scale") else 0.0
        layer[name] = (base + randn(n, scale=0.1)).to(vec)
    for name in ("q", "k", "v", "o"):
        layer[name] = randn(width, width, scale=WEIGHT_STD).to(mat)
    layer["mlp_fc"] = randn(width, d_ff, scale=WEIGHT_STD).to(mat)
    layer["mlp_proj"] = randn(d_ff, width, scale=WEIGHT_STD).to(mat)
    return randn(batch, seq, width).to(act), layer


def block_args(x, layer, heads):
    return (x, *(layer[n] for n in BLOCK_KEYS), heads)


def attn_args(x, layer, heads):
    return (x, *(layer[n] for n in ATTN_KEYS), heads)


# --- on the CPU: the recorded launches --------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """Every CUDA wrapper's launcher replaced by one that records the
    call's name and its integer arguments (and launches nothing), a stub
    stream and the H100's whole-block attention limit: meta tensors then
    take the CUDA path up to the launch."""
    calls = []

    def launcher_of(lib, name, n_ptrs, n_ints, n_floats):
        def launch(*args):
            assert len(args) == n_ptrs + n_ints + n_floats + 1
            calls.append((name, args[n_ptrs:n_ptrs + n_ints]))
            return 0
        return launch

    def flash_launcher(f32):
        def launch(*args):
            calls.append(("flash_attention_f32" if f32 else
                          "flash_attention", args[5:-1]))
            return 0
        return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tfab, "_launcher_of", launcher_of)
    monkeypatch.setattr(tattn, "_launcher", flash_launcher)
    monkeypatch.setattr(tfab, "_kernel_max_len",
                        lambda lib, symbol, dh: H100_VIT_MAX_LEN)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    return calls


def meta_layer(act, vec, mat, batch=2, seq=50, width=768):
    """block_layer's shapes and dtypes as meta tensors (no data)."""
    d_ff = 4 * width
    shapes = {name: (d_ff,) if name == "mlp_fc_bias" else (width,)
              for name in BLOCK_VECS}
    shapes.update({name: (width, width) for name in ("q", "k", "v", "o")},
                  mlp_fc=(width, d_ff), mlp_proj=(d_ff, width))
    return (torch.empty((batch, seq, width), dtype=act, device="meta"),
            {name: torch.empty(shape, device="meta",
                               dtype=vec if name in BLOCK_VECS else mat)
             for name, shape in shapes.items()})


BLOCK_RUNS = {"normalised": (50, {}), "fast_exp": (50, {"fast_exp": True}),
              "whole": (577, {}), "whole_dd": (577, {"deferred_div": True})}


@pytest.mark.parametrize("form", list(FORMS), ids=lambda f: "-".join(
    str(t).removeprefix("torch.") for t in f))
@pytest.mark.parametrize("run", list(BLOCK_RUNS))
def test_fused_vit_block_launches_the_form_of_its_dtypes(recorded, run,
                                                         form):
    """One launch counted, with the form's x_f32 and params_f32 flags and
    the softmax order, at ViT-B/32's 50 tokens (12 heads of 64) and at
    ViT-L/14@336's 577 (16 heads, group 1: whole, whole_dd); the output in
    x's dtype."""
    seq, kw = BLOCK_RUNS[run]
    width, heads = (768, 12) if seq == 50 else (1024, 16)
    x, layer = meta_layer(*form, seq=seq, width=width)
    before = tfab.fused_vit_block.launches
    out = tfab.fused_vit_block(*block_args(x, layer, heads),
                               group=2 if seq == 50 else 1, **kw)
    assert tfab.fused_vit_block.launches == before + 1
    assert out.dtype == form[0] and out.shape == x.shape
    (name, ints), = recorded
    assert name == "fused_vit_block"
    x_f32, params_f32 = FORMS[form]
    mode = tfab.SOFTMAX_MODES[tfab._vit_block_softmax(
        kw.get("deferred_div", False), kw.get("fast_exp", False))]
    assert ints == (2, seq, heads, 64, 4 * width, mode, x_f32, params_f32)


def test_fused_vit_block_refuses_other_dtypes(recorded):
    x, layer = meta_layer(F32, F32, F32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfab.fused_vit_block(*block_args(x.to(torch.float16), layer, 12),
                             group=2)
    layer["mlp_fc"] = layer["mlp_fc"].to(torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfab.fused_vit_block(*block_args(x, layer, 12), group=2)
    assert not recorded


# (x, weights and biases) dtypes x the chain
ATTN_FORMS = [(x, w) for x in (BF16, F32) for w in (BF16, F32)]
CHAINS = {"block_diag": {"block_diag": True},
          "unblocked_f32": {"compute_dtype": F32},
          "unblocked_bf16": {"compute_dtype": BF16}}


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("x_dtype,w_dtype", ATTN_FORMS, ids=lambda t: str(
    t).removeprefix("torch."))
def test_fused_attention_block_launches_the_form_of_its_dtypes(
        recorded, x_dtype, w_dtype, chain):
    """ViT-B/32's 50 tokens, the weights and biases as the tower passes them
    (the activations' dtype): the fp32 chain's launch with its x_f32, w_f32
    and b_f32 flags and the block kernel's route; the bf16 chain's with an
    fp32 output for fp32 x (its weights cast to bf16); one launch counted,
    the output in x's dtype."""
    x, layer = meta_layer(x_dtype, w_dtype, w_dtype)
    before = tfab.fused_attention_block.launches
    out = tfab.fused_attention_block(*attn_args(x, layer, 12), group=2,
                                     **CHAINS[chain])
    assert tfab.fused_attention_block.launches == before + 1
    assert out.dtype == x_dtype and out.shape == x.shape
    (name, ints), = recorded
    x_f32, w_f32 = int(x_dtype == F32), int(w_dtype == F32)
    if chain == "unblocked_bf16":
        assert name == "fused_attention_block_bf16"
        assert ints == (2, 50, 12, 64, x_f32, w_f32)
    else:
        assert name == "fused_attention_block"
        assert ints == (2, 50, 12, 64, x_f32, w_f32, w_f32, tfab.F32_BLOCK)


ATTN_ROUTES = [(128, 64, tfab.F32_BLOCK), (129, 64, tfab.F32_HELD),
               (200, 64, tfab.F32_HELD), (576, 64, tfab.F32_HELD),
               (577, 64, tfab.F32_HELD_KS), (650, 64, tfab.F32_TWO_PASS),
               (128, 32, tfab.F32_BLOCK), (200, 128, tfab.F32_HELD),
               (300, 128, tfab.F32_TWO_PASS)]


@pytest.mark.parametrize("seq,head_dim,route", ATTN_ROUTES)
def test_fused_attention_block_route_by_length(recorded, seq, head_dim,
                                               route):
    """The fp32 chain's attention: the block kernel up to 128 tokens (every
    head size), past that csrc/attention_f32.cuh by vit_f32_route (the held
    route, the held route with K in the score rows at 577 tokens, two passes
    past 640); fp32 x and weights."""
    x, layer = meta_layer(F32, F32, F32, seq=seq, width=8 * head_dim)
    tfab.fused_attention_block(*attn_args(x, layer, 8), group=1,
                               block_diag=True)
    (name, ints), = recorded
    assert ints[3] == head_dim and ints[-1] == route
    if route != tfab.F32_BLOCK:
        assert route == tfab.vit_f32_route(seq, head_dim)


def test_fused_attention_block_past_128_tokens_needs_an_f32_head_size(
        recorded):
    """Past 128 tokens the fp32 attention is csrc/attention_f32.cuh's (head
    sizes 64 and 128): head size 32 raises there, and runs at 128."""
    x, layer = meta_layer(F32, F32, F32, seq=129, width=256)
    with pytest.raises(ValueError, match="head size 32"):
        tfab.fused_attention_block(*attn_args(x, layer, 8), group=1,
                                   block_diag=True)
    x, layer = meta_layer(BF16, BF16, BF16, seq=128, width=256)
    tfab.fused_attention_block(*attn_args(x, layer, 8), group=1,
                               block_diag=True)
    assert len(recorded) == 1


def test_fused_attention_block_reads_mixed_operands_in_fp32(recorded):
    """One fp32 weight among bf16 ones: the fp32 chain reads every weight
    as fp32 planes (a bf16 one widened, which is exact), the bf16 chain
    casts it to bf16; one fp32 bias: all read in fp32."""
    x, layer = meta_layer(BF16, BF16, BF16)
    layer["k"] = layer["k"].float()
    layer["v_bias"] = layer["v_bias"].float()
    args = attn_args(x, layer, 12)
    tfab.fused_attention_block(*args, group=2, block_diag=True)
    tfab.fused_attention_block(*args, group=2, compute_dtype=BF16)
    assert recorded[0][1][4:7] == (0, 1, 1)
    assert recorded[1][1][4:] == (0, 1)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfab.fused_attention_block(x.to(torch.float16), *args[1:], group=2,
                                   block_diag=True)


def meta_qkv(batch, lq, lk, heads, head_dim, dtype=F32):
    def t(length):
        return torch.empty((batch, length, heads, head_dim), dtype=dtype,
                           device="meta")
    return t(lq), t(lk), t(lk)


FLASH_CASES = {
    # name: (batch, lq, lk, heads, head_dim, bias shape or None)
    "vit_l": (2, 577, 577, 16, 64, None),
    "vit_b32": (4, 50, 50, 12, 64, None),
    "key_mask": (3, 70, 200, 4, 64, "key_mask"),
    "per_batch_head": (3, 70, 200, 4, 64, "per_batch_head"),
    "long_keys": (2, 96, 2500, 4, 64, "key_mask"),
    "head_dim_128": (2, 577, 577, 8, 128, "per_batch_head"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_launches_its_fp32_form(recorded, case):
    """fp32 q, k, v: the fp32 launcher with JAX's padded keys, the route
    vit_f32_route gives for Lk and the bias's four broadcast strides (the
    key stride among them); one launch counted, an fp32 output."""
    batch, lq, lk, heads, head_dim, kind = FLASH_CASES[case]
    q, k, v = meta_qkv(batch, lq, lk, heads, head_dim)
    bias, strides = None, (0, 0, 0, 0)
    if kind == "key_mask":
        bias = torch.empty((batch, 1, 1, lk), device="meta")
        strides = (lk, 0, 0, 1)
    elif kind == "per_batch_head":
        bias = torch.empty((batch, heads, lq, lk), device="meta")
        strides = (heads * lq * lk, lq * lk, lk, 1)
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v, bias)
    assert tattn.flash_attention.launches == before + 1
    assert out.dtype == F32 and out.shape == q.shape
    (name, ints), = recorded
    assert name == "flash_attention_f32"
    assert ints == (batch, lq, lk, heads, head_dim,
                    tattn.padded_key_len(lk) - lk,
                    tfab.vit_f32_route(lk, head_dim), *strides)


def test_flash_attention_refuses_mixed_and_unsupported_fp32(recorded):
    """q, k, v of two dtypes, float16, and fp32 at head size 32 (the fp32
    form's attention takes 64 and 128) raise before any launch."""
    q, k, v = meta_qkv(2, 50, 50, 4, 64)
    with pytest.raises(ValueError, match="one dtype"):
        tattn.flash_attention(q, k.to(BF16), v)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        tattn.flash_attention(*(t.to(torch.float16) for t in (q, k, v)))
    with pytest.raises(ValueError, match="head size 32"):
        tattn.flash_attention(*meta_qkv(2, 50, 50, 4, 32))
    tattn.flash_attention(*meta_qkv(2, 50, 50, 4, 32, BF16))
    assert [name for name, _ in recorded] == ["flash_attention"]


# --- on the CPU: the tower in fp32 reaches each fp32 form -------------------

TOWER_PATHS = {
    # name: (config changes, image size, the wrapper and its launches)
    "fused_block": (dict(fused_block=True), 28, "fused_vit_block"),
    "whole": (dict(fused_block=True, fused_block_long="whole"), 56,
              "fused_vit_block"),
    "whole_dd": (dict(fused_block=True, fused_block_long="whole_dd"), 56,
                 "fused_vit_block"),
    "fused_attention": (dict(fused_attention=True), 28,
                        "fused_attention_block"),
    "use_pallas": ({}, 28, "flash_attention_f32"),
    "use_pallas_long": ({}, 56, "flash_attention_f32"),
}


@pytest.mark.parametrize("path", list(TOWER_PATHS))
def test_fp32_tower_reaches_each_fp32_form(recorded, path):
    """clip_encode_image at cfg.dtype=float32 with fp32 parameters (width
    128, 2 heads of 64, 3 layers; patch 4: 50 tokens at 28 px, 197 at 56)
    on meta tensors: each layer launches the path's kernel in its fp32
    form, and nothing raises."""
    changes, image, kernel = TOWER_PATHS[path]
    cfg = tclip.CLIPVisionConfig(
        image_size=image, patch_size=4, width=128, num_layers=3, num_heads=2,
        projection_dim=64, dtype=F32, **changes)
    params = tclip.init_clip_vision_params(torch.Generator().manual_seed(0),
                                           cfg, F32)

    def to_meta(tree):
        if isinstance(tree, dict):
            return {key: to_meta(val) for key, val in tree.items()}
        return tree.to("meta")

    images = torch.empty((4, image, image, 3), device="meta")
    out = tclip.clip_encode_image(to_meta(params), cfg, images,
                                  use_pallas=path.startswith("use_pallas"))
    assert out.shape == (4, 64) and out.dtype == F32
    assert [name for name, _ in recorded] == [kernel] * 3
    for _, ints in recorded:
        if kernel == "fused_vit_block":
            assert ints[-2:] == (1, 1)             # x_f32, params_f32
        elif kernel == "fused_attention_block":
            assert ints[4:7] == (1, 1, 1)          # x, weights, biases fp32


# --- on the CPU: the plain version against the Pallas kernel past 128 ------

@pytest.mark.parametrize("seq", [129, 200])
@pytest.mark.parametrize("group", [1, 2])
def test_attention_block_plain_matches_pallas_past_128_tokens(seq, group):
    """Width 128, 2 heads of 64, 2 images, fp32, block_diag: the plain
    version (the fp32 chain's function at any length) against the JAX
    package's Pallas kernel in interpret mode, within F32_TOL (1 + |want|):
    only the order of the sums differs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    x, layer = block_layer(128, 2, F32, F32, F32, 2, seq, seed=seq)
    want = jfab.fused_attention_block(
        jnp.asarray(x.numpy()), *(jnp.asarray(layer[n].numpy())
                                  for n in ATTN_KEYS),
        num_heads=2, group=group, interpret=True, block_diag=True)
    got = tfab.fused_attention_block(*attn_args(x, layer, 2), group=group,
                                     block_diag=True)
    held, figures = exact_rule(got, torch.from_numpy(np.array(want)))
    assert held, figures


# --- on the CPU: the rules fail forms that round to bf16 -------------------

def block_mutant(args, where):
    """fused_vit_block_plain with x ("x") or the output ("out") rounded to
    bf16."""
    args = list(args)
    if where == "x":
        args[0] = bf16(args[0])
    out = tfab.fused_vit_block_plain(*args)
    return bf16(out) if where == "out" else out


def attention_block_mutant(args, where):
    """fused_attention_block_plain (block_diag) with x, the weights or the
    output rounded to bf16."""
    args = list(args)
    if where == "x":
        args[0] = bf16(args[0])
    if where == "weights":
        for i in (1, 3, 5, 7):
            args[i] = bf16(args[i])
    out = tfab.fused_attention_block_plain(*args, block_diag=True)
    return bf16(out) if where == "out" else out


def flash_mutant(q, k, v, bias, where):
    """flash_attention_plain with q, k, v ("qkv") or the output rounded."""
    if where == "qkv":
        q, k, v = bf16(q), bf16(k), bf16(v)
    out = tattn.flash_attention_plain(q, k, v, bias)
    return bf16(out) if where == "out" else out


def softmax_pv_f64(q, k, v, bias=None):
    """softmax(q k^T + bias) v over (B, H, L, dh) in fp64."""
    s = q @ k.transpose(-1, -2)
    if bias is not None:
        s = s + bias
    return torch.softmax(s, dim=-1) @ v


def attention_block_f64(x, wq, bq, wk, bk, wv, bv, wo, bo, heads):
    """fused_attention_block's fp32 function in fp64, rounded to fp32:
    another valid evaluation of it (other sums, no fp32 roundings)."""
    x, wq, bq, wk, bk, wv, bv, wo, bo = (t.double() for t in (
        x, wq, bq, wk, bk, wv, bv, wo, bo))
    batch, seq, width = x.shape

    def split(t):
        return t.reshape(batch, seq, heads, -1).transpose(1, 2)

    q = (x @ wq + bq) * (width // heads) ** -0.5
    o = softmax_pv_f64(split(q), split(x @ wk + bk), split(x @ wv + bv))
    return (o.transpose(1, 2).reshape(x.shape) @ wo + bo).float()


def flash_f64(q, k, v, bias):
    """flash_attention's function in fp64 over (B, L, H, dh), for rows with
    a key the bias leaves (the padded keys add nothing there)."""
    out = softmax_pv_f64(*(t.double().transpose(1, 2) for t in (q, k, v)),
                         bias.double())
    return out.transpose(1, 2).float()


@pytest.mark.parametrize("where", ["x", "out"])
def test_block_rule_fails_bf16_roundings(where):
    """fused_vit_block's rule, against the plain version's bf16 form on x
    rounded to bf16, holds its fp32 plain version against itself and fails
    it with x or the output rounded to bf16 (50 tokens, width 128, 2 heads
    of 64)."""
    x, layer = block_layer(128, 2, F32, F32, F32, 2, 50, seed=11)
    args = block_args(x, layer, 2)
    want = tfab.fused_vit_block_plain(*args)
    bf16_form = tfab.fused_vit_block_plain(x.to(BF16), *args[1:])
    assert block_rule(want, want, bf16_form)[0]
    held, figures = block_rule(block_mutant(args, where), want, bf16_form)
    assert not held, figures


@pytest.mark.parametrize("where", ["x", "weights", "out"])
@pytest.mark.parametrize("seq", [50, 200])
def test_attention_block_rule_fails_bf16_roundings(seq, where):
    """fused_attention_block's rule holds its fp32 plain version against
    the same function in fp64 (another order of the sums) and fails it with
    x, the weights or the output rounded to bf16."""
    x, layer = block_layer(128, 2, F32, F32, F32, 2, seq, seed=12)
    args = attn_args(x, layer, 2)
    want = tfab.fused_attention_block_plain(*args, block_diag=True)
    held, figures = exact_rule(attention_block_f64(*args), want)
    assert held, figures
    held, figures = exact_rule(attention_block_mutant(args, where), want)
    assert not held, figures


@pytest.mark.parametrize("where", ["qkv", "out"])
def test_flash_rule_fails_bf16_roundings(where):
    """flash_attention's rule holds its fp32 plain version against fp64 and
    fails it with q, k, v or the output rounded to bf16 (a key-mask bias,
    200 keys, 2 heads of 64)."""
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn((2, length, 2, 64), generator=gen)
               for length in (70, 200, 200))
    q = q * 64 ** -0.5
    bias = torch.zeros((2, 1, 1, 200))
    bias[1, ..., 150:] = -1e9
    want = tattn.flash_attention_plain(q, k, v, bias)
    held, figures = exact_rule(flash_f64(q, k, v, bias), want)
    assert held, figures
    held, figures = exact_rule(flash_mutant(q, k, v, bias, where), want)
    assert not held, figures


# --- on the card: each fp32 form against its plain version -----------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # exact plain versions
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def check_form(got, want):
    """fp32 outputs by the rule given, bf16 ones by the bf16 forms'."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())


def within_bf16_rule(got, want):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return bool((err <= BF16_TOL * (1 + w.abs())).all()), err.max().item()


# name -> (activations, vectors, weights)
BLOCK_FORMS = {"f32": (F32, BF16, BF16), "f32_params_f32": (F32, F32, F32),
               "bf16_params_f32": (BF16, F32, F32)}
# (tower, images, mode)
BLOCK_SHAPES = [("vit_b_32", 8, "normalised"), ("vit_b_32", 8, "fast_exp"),
                ("vit_b_32", 8, "deferred_div"), ("vit_l_14_336", 2, "whole"),
                ("vit_l_14_336", 2, "whole_dd")]
MODE_KW = {"normalised": {}, "fast_exp": {"fast_exp": True},
           "deferred_div": {"deferred_div": True}, "whole": {},
           "whole_dd": {"deferred_div": True}}


@pytest.mark.gpu
@pytest.mark.parametrize("tower,batch,mode", BLOCK_SHAPES)
@pytest.mark.parametrize("form", list(BLOCK_FORMS))
def test_cuda_fused_vit_block_forms_match_plain(card, form, tower, batch,
                                                mode):
    """ViT-B/32 widths at 50 tokens on 8 images (group 4) in each softmax
    order, ViT-L/14@336's at 577 on 2 (group 1: whole, whole_dd): fp32
    outputs by fused_vit_block's fp32 rule (against the kernel's bf16 form
    on x rounded to bf16, the same parameters), bf16 ones (fp32 parameters)
    by the bf16 forms'; one launch counted."""
    cfg = getattr(tclip.CLIPVisionConfig, tower)()
    x, layer = block_layer(cfg.width, cfg.num_heads, *BLOCK_FORMS[form],
                           batch, cfg.seq_len, card)
    args = block_args(x, layer, cfg.num_heads)
    kw = MODE_KW[mode]
    before = tfab.fused_vit_block.launches
    got = tfab.fused_vit_block(*args, group=4 if batch == 8 else 1, **kw)
    torch.cuda.synchronize()
    assert tfab.fused_vit_block.launches == before + 1
    want = tfab.fused_vit_block_plain(*args, **kw)
    check_form(got, want)
    if got.dtype == F32:
        bf16_form = tfab.fused_vit_block(x.to(BF16), *args[1:],
                                         group=4 if batch == 8 else 1, **kw)
        held, figures = block_rule(got, want, bf16_form)
    else:
        held, figures = within_bf16_rule(got, want)
    assert held, figures


@pytest.mark.gpu
def test_cuda_fused_vit_block_mixed_form_is_the_bf16_form(card):
    """bf16 x with bf16-valued fp32 parameters: bit for bit the bf16
    form's output."""
    cfg = tclip.CLIPVisionConfig.vit_b_32()
    x, layer = block_layer(cfg.width, cfg.num_heads, BF16, BF16, BF16, 8,
                           cfg.seq_len, card, seed=1)
    widened = {name: t.float() for name, t in layer.items()}
    want = tfab.fused_vit_block(*block_args(x, layer, cfg.num_heads))
    got = tfab.fused_vit_block(*block_args(x, widened, cfg.num_heads))
    assert torch.equal(got, want)


# (width, heads, images, tokens): ViT-B/32 at 50 (the block kernel),
# ViT-L/14@336's widths at 577 (the held route with K in the score rows),
# at 129 (the held route) and at 650 (two passes)
ATTN_SHAPES = [(768, 12, 8, 50), (1024, 16, 2, 577), (1024, 16, 2, 129),
               (1024, 16, 1, 650)]


@pytest.mark.gpu
@pytest.mark.parametrize("width,heads,batch,seq", ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype,w_dtype", ATTN_FORMS, ids=lambda t: str(
    t).removeprefix("torch."))
def test_cuda_fused_attention_block_forms_match_plain(card, x_dtype,
                                                      w_dtype, width, heads,
                                                      batch, seq):
    """The fp32 chain (block_diag) on x and weights each bf16 or fp32, the
    biases in the weights' dtype: fp32 outputs within F32_TOL (1 + |want|)
    of the plain version, bf16 ones (bf16 x) within one bf16 rounding of
    it; one launch counted."""
    x, layer = block_layer(width, heads, x_dtype, w_dtype, w_dtype, batch,
                           seq, card, seed=seq)
    args = attn_args(x, layer, heads)
    before = tfab.fused_attention_block.launches
    got = tfab.fused_attention_block(*args, group=1, block_diag=True)
    torch.cuda.synchronize()
    assert tfab.fused_attention_block.launches == before + 1
    want = tfab.fused_attention_block_plain(*args, block_diag=True)
    check_form(got, want)
    held, figures = (exact_rule(got, want) if got.dtype == F32
                     else within_bf16_rule(got, want))
    assert held, figures


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [BF16, F32])
def test_cuda_bf16_chain_on_fp32_x_matches_plain(card, w_dtype):
    """compute_dtype bfloat16 on fp32 x at ViT-B/32 widths: x and the
    weights cast to bf16, the output fp32 from the fp32 sum, by the bf16
    forms' rule."""
    x, layer = block_layer(768, 12, F32, w_dtype, w_dtype, 8, 50, card)
    args = attn_args(x, layer, 12)
    got = tfab.fused_attention_block(*args, group=4, compute_dtype=BF16)
    torch.cuda.synchronize()
    want = tfab.fused_attention_block_plain(*args, compute_dtype=BF16)
    check_form(got, want)
    held, err = within_bf16_rule(got, want)
    assert held, err


# name: (batch, lq, lk, heads, head_dim, bias kind)
CUDA_FLASH_CASES = {
    "vit_l": (2, 577, 577, 16, 64, None),
    "vit_b32": (16, 50, 50, 12, 64, None),
    "key_mask": (3, 70, 200, 4, 64, "key_mask"),
    "per_batch_head": (3, 70, 200, 4, 64, "per_batch_head"),
    "broadcast_heads": (3, 70, 200, 4, 64, "per_head_row"),
    "fully_masked_row": (3, 70, 200, 4, 64, "fully_masked_row"),
    "lq_ne_lk": (2, 13, 237, 4, 64, None),
    "long_keys": (2, 96, 2500, 4, 64, "key_mask"),
    "head_dim_128": (2, 577, 577, 8, 128, "per_batch_head"),
    # the held route with K in the score rows (577..640 keys at head size
    # 64): E·V on the tensor cores under a key mask, a bias, a row masked
    # entirely (JAX's padded keys in the denominator) and Lq != Lk
    "key_mask_577": (2, 577, 577, 4, 64, "key_mask"),
    "per_batch_head_640": (2, 64, 640, 4, 64, "per_batch_head"),
    "fully_masked_row_600": (3, 70, 600, 4, 64, "fully_masked_row"),
    "lq_ne_lk_600": (2, 13, 600, 4, 64, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CUDA_FLASH_CASES))
def test_cuda_flash_attention_f32_matches_plain(card, case):
    """fp32 q, k, v under each bias kind (broadcast along the batch, the
    heads, the rows or the keys), a row the bias masks entirely (JAX's
    padded keys counted), Lq != Lk, 2,500 keys and head size 128, and at
    577 to 640 keys the held route with K in the score rows under a key
    mask, a bias, a masked row and Lq != Lk: every output within F32_TOL
    (1 + |want|) of the plain version; one launch counted."""
    batch, lq, lk, heads, head_dim, kind = CUDA_FLASH_CASES[case]
    if case.endswith(("_577", "_600", "_640")):
        assert tfab.vit_f32_route(lk, head_dim) == tfab.F32_HELD_KS
    gen = torch.Generator(device=card).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card)

    q = randn(batch, lq, heads, head_dim) * head_dim ** -0.5
    k, v = randn(batch, lk, heads, head_dim), randn(batch, lk, heads,
                                                    head_dim)
    bias = None
    if kind == "per_batch_head":
        bias = randn(batch, heads, lq, lk)
    elif kind == "per_head_row":
        bias = randn(1, heads, lq, 1)
    elif kind is not None:
        valid = [lk - 50 * b for b in range(batch)]
        valid[-1] = 0 if kind == "fully_masked_row" else 9
        bias = torch.zeros((batch, 1, 1, lk), device=card)
        for b, n in enumerate(valid):
            bias[b, ..., n:] = -1e9
    before = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    want = tattn.flash_attention_plain(q, k, v, bias)
    check_form(got, want)
    held, figures = exact_rule(got, want)
    assert held, figures
    if kind == "fully_masked_row":
        shrunk = v[-1].mean(dim=0) * lk / tattn.padded_key_len(lk)
        assert torch.allclose(got[-1], shrunk.expand_as(got[-1]),
                              atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_fp32_tower_matches_default_path(card):
    """ViT-B/32 at 2 layers on 16 images with fp32 parameters and
    activations: fused_block, fused_attention and use_pallas against the
    default path, per-row cosine >= 0.9999, each layer launching the
    path's kernel once."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.tools.clip_encoder import (
        ClipImageEncoder,
    )

    cfg = tclip.CLIPVisionConfig.vit_b_32(num_layers=2, dtype=F32)
    params = tclip.init_clip_vision_params(
        torch.Generator(device=card).manual_seed(0), cfg, F32)
    images = torch.randn((16, 224, 224, 3), device=card)
    paths = {"default": (cfg, False, None),
             "fused_block": (dataclasses.replace(cfg, fused_block=True),
                             False, tfab.fused_vit_block),
             "fused_attention": (dataclasses.replace(cfg,
                                                     fused_attention=True),
                                 False, tfab.fused_attention_block),
             "use_pallas": (cfg, True, tattn.flash_attention)}
    outs = {}
    for name, (path_cfg, pallas, fn) in paths.items():
        encoder = ClipImageEncoder(path_cfg, params, batch_size=16,
                                   param_dtype=F32, use_pallas=pallas,
                                   device=card)
        before = fn.launches if fn else 0
        outs[name] = encoder.encode_batch(images)
        if fn:
            assert fn.launches == before + 2, name
    for name, out in outs.items():
        cosine = (out * outs["default"]).sum(-1) / (
            np.linalg.norm(out, axis=-1)
            * np.linalg.norm(outs["default"], axis=-1))
        assert (cosine >= 0.9999).all(), (name, cosine.min())
