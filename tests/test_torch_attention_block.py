"""The port's fused_attention_block without block_diag (JAX's _make_kernel):
the plain version against the JAX package's Pallas kernel (interpret mode
on the CPU) in compute_dtype float32 and bfloat16, with groups of 1, 2 and
4 images, at 5 and 50 tokens and head sizes 64 and 32; the fp32 form bit
for bit the block-diagonal one; the wrapper on CPU tensors for both flags;
and the CUDA kernels against the plain version on the card."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from test_torch_vit_kernels import bf16_ulp_of  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# head size -> (width, heads)
WIDTHS = {64: (128, 2), 32: (64, 2)}
ATTN_KEYS = ("q", "q_bias", "k", "k_bias", "v", "v_bias", "o", "o_bias")
# tests/test_torch_vit_block.py's rules. fp32 (x, weights and compute):
# only the order of the fp32 sums differs, every element within FP32_TOL
# (|want| + rms(want)). A bf16 output: every element within one bf16 ulp of
# JAX's and at least MIN_EQUAL of them equal.
FP32_TOL = 1e-5
MIN_EQUAL = 0.999
# (x and weight dtype, compute_dtype): the all-fp32 block; the card's two
# forms, bf16 inputs computed in fp32 or in bf16
FORMS = {"f32": ("float32", "float32"), "bf16_in_f32": ("bfloat16", "float32"),
         "bf16": ("bfloat16", "bfloat16")}


def make_inputs(seed, batch, seq, head_dim):
    """x and one layer's attention parameters as numpy fp32: the CLIP
    towers' init scale (std 0.02) for the weights, x of order 1, biases of
    order 0.1."""
    rng = np.random.default_rng(seed)
    width, _ = WIDTHS[head_dim]
    layer = {}
    for name in ("q", "k", "v", "o"):
        layer[name] = (rng.standard_normal((width, width)) * 0.02) \
            .astype(np.float32)
        layer[name + "_bias"] = (rng.standard_normal(width) * 0.1) \
            .astype(np.float32)
    return rng.standard_normal((batch, seq, width)).astype(np.float32), layer


def run_jax(x, layer, head_dim, form, group, block_diag=False):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    dtype, compute = FORMS[form]
    jd = getattr(jnp, dtype)
    out = jfab.fused_attention_block(
        jnp.asarray(x, jd), *(jnp.asarray(layer[n], jd) for n in ATTN_KEYS),
        num_heads=WIDTHS[head_dim][1], group=group, interpret=True,
        compute_dtype=getattr(jnp, compute), block_diag=block_diag)
    return np.asarray(out.astype(jnp.float32))


def port_args(x, layer, head_dim, dtype):
    td = TORCH_DTYPES[dtype]
    return (torch.from_numpy(x).to(td),
            *(torch.from_numpy(layer[n]).to(td) for n in ATTN_KEYS),
            WIDTHS[head_dim][1])


def run_port(fn, x, layer, head_dim, form, **kw):
    dtype, compute = FORMS[form]
    out = fn(*port_args(x, layer, head_dim, dtype),
             compute_dtype=TORCH_DTYPES[compute], **kw)
    assert out.dtype == TORCH_DTYPES[dtype] and tuple(out.shape) == x.shape
    return out.float().numpy()


def assert_close(got, want, form):
    if FORMS[form][0] == "bfloat16":
        assert (np.abs(got - want) <= bf16_ulp_of(want)).all(), \
            np.abs(got - want).max()
        assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()
        return
    rel = np.abs(got - want) / (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    assert rel.max() <= FP32_TOL, rel.max()


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("seq", [5, 50])
def test_unblocked_plain_matches_pallas_kernel(seq, group, form):
    """Head size 64 on 4 images: JAX's kernel at each group (it loops over
    the group's images) against the port's plain version."""
    x, layer = make_inputs(seed=seq + group, batch=4, seq=seq, head_dim=64)
    want = run_jax(x, layer, 64, form, group)
    got = run_port(tfab.fused_attention_block_plain, x, layer, 64, form)
    assert_close(got, want, form)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("seq", [5, 50])
def test_unblocked_plain_matches_pallas_kernel_head_size_32(seq, form):
    """Head size 32, whose scale (32^-0.5) is no power of two: in bf16 the
    scaled q rounds once more, after q's own rounding, as in JAX."""
    x, layer = make_inputs(seed=7 + seq, batch=2, seq=seq, head_dim=32)
    want = run_jax(x, layer, 32, form, 2)
    got = run_port(tfab.fused_attention_block_plain, x, layer, 32, form)
    assert_close(got, want, form)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [5, 50])
def test_fp32_unblocked_equals_block_diag(seq, dtype):
    """compute_dtype float32 without block_diag is the block-diagonal
    function (the -1e30 on other images' keys gives them exact zeros): the
    two plain versions agree bit for bit."""
    x, layer = make_inputs(seed=11, batch=2, seq=seq, head_dim=64)
    args = port_args(x, layer, 64, dtype)
    unblocked = tfab.fused_attention_block_plain(
        *args, block_diag=False, compute_dtype=torch.float32)
    blocked = tfab.fused_attention_block_plain(*args, block_diag=True)
    assert torch.equal(unblocked, blocked)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("block_diag", [False, True])
def test_wrapper_takes_plain_version_on_cpu(block_diag, form):
    x, layer = make_inputs(seed=12, batch=4, seq=5, head_dim=64)
    before = tfab.fused_attention_block.launches
    got = run_port(tfab.fused_attention_block, x, layer, 64, form, group=2,
                   block_diag=block_diag)
    want = run_port(tfab.fused_attention_block_plain, x, layer, 64, form,
                    block_diag=block_diag)
    np.testing.assert_array_equal(got, want)
    assert tfab.fused_attention_block.launches == before


def test_wrapper_refuses_other_compute_dtypes():
    x, layer = make_inputs(seed=13, batch=2, seq=5, head_dim=64)
    args = port_args(x, layer, 64, "float32")
    for fn in (tfab.fused_attention_block, tfab.fused_attention_block_plain):
        with pytest.raises(ValueError, match="compute_dtype"):
            fn(*args, compute_dtype=torch.float16)


# --- on the card: the CUDA kernels against the plain version ---------------

def cuda_attention_layer(cfg, batch):
    """x and one layer's attention parameters at ``cfg``'s widths on the
    card, bf16: init-scale weights, biases of order 0.1."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = {name: leaf[0] for name, leaf in tclip.init_clip_vision_params(
        gen, cfg)["blocks"].items()}
    for name in ATTN_KEYS:
        if name.endswith("bias"):
            layer[name] = (0.1 * torch.randn(
                layer[name].shape, generator=gen, device="cuda")).bfloat16()
    x = torch.randn((batch, cfg.seq_len, cfg.width), generator=gen,
                    device="cuda").bfloat16()
    return (x, *(layer[n] for n in ATTN_KEYS), cfg.num_heads)


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_cuda_unblocked_matches_plain_version(compute):
    """ViT-B/32 widths on 8 images without block_diag. fp32: within one
    bf16 ulp of the plain version's output (the larger of the two values',
    at least that of rms / 256), as the block-diagonal kernel. bf16: the
    roundings of q, k, v, p and o are the plain version's, the fp32 sums in
    another order: within one bf16 ulp or 8e-3 (1 + |want|) where an
    intermediate rounding went the other way. One launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = cuda_attention_layer(tclip.CLIPVisionConfig.vit_b_32(), 8)
    dtype = TORCH_DTYPES[compute]
    before = tfab.fused_attention_block.launches
    got = tfab.fused_attention_block(*args, group=4, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert tfab.fused_attention_block.launches == before + 1
    got = got.float().cpu().numpy()
    want = tfab.fused_attention_block_plain(*args, compute_dtype=dtype) \
        .float().cpu().numpy()
    assert np.isfinite(got).all()
    if compute == "float32":
        floor = np.sqrt(np.mean(want ** 2)) / 256
        ulp = bf16_ulp_of(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                     floor))
        assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    else:
        err = np.abs(got - want)
        assert (err <= 8e-3 * (1 + np.abs(want))).all(), err.max()
