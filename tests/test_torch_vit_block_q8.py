"""The port's int8 whole-block CLIP kernel fused_vit_block_q8: its plain
version against the JAX package's Pallas kernel (interpret mode on the CPU)
in fp32 and bf16, at 5 and 50 tokens and with groups of 1, 2 and 4 images,
on inputs clear of the .5 code boundaries and with one code pinned on one;
the wrapper on CPU tensors; and the CUDA kernel against the plain version on
the card."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import kernel_probe
from test_torch_int8_kernels import (  # noqa: E402
    near_boundary,
    nudge_columns,
    nudge_rows,
    settle_clear_of_boundaries,
)
from test_torch_vit_block import (  # noqa: E402
    EPS,
    FLIP_TOL,
    HEADS,
    WIDTH,
    assert_close,
    jax_fab,
    make_inputs,
)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Q8_KEYS = ("ln1_scale", "ln1_bias", "qkv", "qkv_scale", "qkv_bias", "o",
           "o_scale", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
           "mlp_fc_scale", "mlp_fc_bias", "mlp_proj", "mlp_proj_scale",
           "mlp_proj_bias")
# On inputs clear of the .5 code boundaries the codes of both sides agree,
# and the outputs are held as fused_vit_block's (test_torch_vit_block's
# assert_close): the attention between the int8 products rounds q, k, v and
# p to bf16 even in fp32, and a rounding that goes the other way may also
# move an attention code across a boundary (a step of a 0.02 weight times a
# scale of about |attn| / 127), all within FLIP_TOL (|want| + rms(want)).
# With one LayerNorm code pinned on a .5 boundary, a code that flips moves
# its row's q, k and v by one code step of the weights (hs 127 max(s), as
# the q8 tests bound it), and through k and v every row of its image; the
# attention's, LN2's and the hidden's codes of that image may flip in turn.
# So the pinned image's rows are held within PINNED_IMAGE_TOL (|want| +
# rms(want)), the other images' within FLIP_TOL.
PINNED_IMAGE_TOL = 1e-3


def q8_inputs(seed=0, batch=4, seq=50):
    """x and one layer's int8 parameters (numpy, the tower's blocks_q8
    names): the weights from the JAX package's quantize_weight_i8, q | k |
    v concatenated."""
    jfab = jax_fab()
    x, layer = make_inputs(seed, batch, seq)
    q8 = {n: layer[n] for n in Q8_KEYS if n in layer}
    q8["qkv"], q8["qkv_scale"] = jfab.quantize_weight_i8(np.concatenate(
        [layer[n] for n in ("q", "k", "v")], axis=1))
    q8["qkv_bias"] = np.concatenate(
        [layer[n + "_bias"] for n in ("q", "k", "v")])
    for name in ("o", "mlp_fc", "mlp_proj"):
        q8[name], q8[name + "_scale"] = jfab.quantize_weight_i8(layer[name])
    return x, q8


def is_float_leaf(name):
    return not name.endswith("_scale") or name.startswith("ln")


def port_args(x, q8, dtype):
    td = TORCH_DTYPES[dtype]

    def t(name):
        a = torch.from_numpy(np.ascontiguousarray(q8[name]))
        return a.to(td) if is_float_leaf(name) and a.is_floating_point() \
            else a

    return (torch.from_numpy(x).to(td), *(t(n) for n in Q8_KEYS), HEADS)


def run_jax(x, q8, dtype, group):
    jfab = jax_fab()
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)

    def a(name):
        arr = np.asarray(q8[name])
        return jnp.asarray(arr, jd) if is_float_leaf(name) and \
            arr.dtype == np.float32 else jnp.asarray(arr)

    out = jfab.fused_vit_block_q8(jnp.asarray(x, jd), *(a(n) for n in Q8_KEYS),
                                  num_heads=HEADS, group=group, eps=EPS,
                                  interpret=True)
    return np.asarray(out.astype(jnp.float32))


def run_port(fn, x, q8, dtype, **kw):
    out = fn(*port_args(x, q8, dtype), **kw)
    assert out.dtype == TORCH_DTYPES[dtype] and tuple(out.shape) == x.shape
    return out.float().numpy()


def stage_codes(monkeypatch, x, q8, dtype):
    """The plain version's unrounded codes t = h / scale of each of its four
    quantizations, in order: LN1, the attention output, LN2, the hidden."""
    codes = []
    row_quant = tfab._row_quant_i8

    def recording(h):
        q, s = row_quant(h)
        codes.append((h / s).numpy())
        return q, s

    with monkeypatch.context() as patch:
        patch.setattr(tfab, "_row_quant_i8", recording)
        tfab.fused_vit_block_q8_plain(*port_args(x, q8, dtype))
    assert len(codes) == 4
    return codes


def settled_inputs(monkeypatch, dtype, seed=0, batch=4, seq=50):
    """q8_inputs moved clear of the .5 boundaries (the int8 tests' rule): x
    where LN1's codes are near one, the v columns' scales where the
    attention output's are, o's where LN2's are and mlp_fc's where the
    hidden's are."""
    x, q8 = q8_inputs(seed, batch, seq)
    v_scale = q8["qkv_scale"][2 * WIDTH:]      # a view: nudged in place
    settle_clear_of_boundaries(
        lambda: stage_codes(monkeypatch, x, q8, dtype),
        [lambda near: nudge_rows(x, near),
         lambda near: nudge_columns(v_scale, near),
         lambda near: nudge_columns(q8["o_scale"], near),
         lambda near: nudge_columns(q8["mlp_fc_scale"], near)])
    return x, q8


def jax_ln1_codes(x, q8, dtype):
    """JAX's LN1 codes, from the kernel's own helpers under jit."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    jfab = jax_fab()
    jd = getattr(jnp, dtype)

    def codes(x, s, b):
        h = jfab._ln_f32(x.reshape(-1, WIDTH).astype(jnp.float32), s, b, EPS)
        return jfab._row_quant_i8(h)[0]

    return np.asarray(jax.jit(codes)(
        *(jnp.asarray(a, jd) for a in (x, q8["ln1_scale"], q8["ln1_bias"]))))


def port_ln1_codes(x, q8, dtype):
    args = port_args(x, q8, dtype)
    h = tfab._ln_f32(args[0].reshape(-1, WIDTH).float(), args[1], args[2],
                     EPS)
    return tfab._row_quant_i8(h)[0].numpy(), (h / tfab._row_quant_i8(h)[1])


# (tokens, images = JAX's group): at 50 tokens two images, whose
# quantizations settle clear of the boundaries in a few dozen rounds
SHAPES = [(5, 4), (50, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,batch", SHAPES)
def test_plain_matches_pallas_kernel(monkeypatch, seq, batch, dtype):
    """Inputs clear of the .5 boundaries, the batch in one JAX group: LN1's
    codes equal JAX's, and the output is within the dtype's tolerance of
    the Pallas kernel's."""
    x, q8 = settled_inputs(monkeypatch, dtype, batch=batch, seq=seq)
    np.testing.assert_array_equal(port_ln1_codes(x, q8, dtype)[0],
                                  jax_ln1_codes(x, q8, dtype))
    want = run_jax(x, q8, dtype, batch)
    got = run_port(tfab.fused_vit_block_q8_plain, x, q8, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_group_changes_only_the_order_of_sums(monkeypatch, group):
    """5 tokens in fp32: JAX's kernel at each group against the port's
    image-by-image plain version."""
    x, q8 = settled_inputs(monkeypatch, "float32", seed=1, seq=5)
    want = run_jax(x, q8, "float32", group)
    got = run_port(tfab.fused_vit_block_q8, x, q8, "float32", group=group)
    assert_close(got, want, "float32")


def test_plain_stays_within_the_flip_bound_on_a_boundary():
    """One LN1 code pinned on a .5 boundary: LN1's codes differ from JAX's
    only near a boundary, the rows of the other images stay within the
    FLIP_TOL and the pinned image's within PINNED_IMAGE_TOL."""
    seq = 5
    x, q8 = q8_inputs(seed=3, seq=seq)
    flat = x.reshape(-1, WIDTH)
    for _ in range(20):     # h and its scale move with x: a fixed point
        t = port_ln1_codes(x, q8, "float32")[1][6, 7].item()
        flat[6, 7] *= np.float32((np.floor(abs(t)) + 0.5) * np.sign(t) / t)
    got_codes, t = port_ln1_codes(x, q8, "float32")
    assert near_boundary(t.numpy())[6, 7]
    differ = got_codes != jax_ln1_codes(x, q8, "float32")
    assert not (differ & ~near_boundary(t.numpy())).any()
    want = run_jax(x, q8, "float32", 4)
    got = run_port(tfab.fused_vit_block_q8_plain, x, q8, "float32")
    rel = np.abs(got - want) / (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    pinned = 6 // seq
    assert rel[pinned].max() <= PINNED_IMAGE_TOL, rel[pinned].max()
    others = np.delete(np.arange(x.shape[0]), pinned)
    assert rel[others].max() <= FLIP_TOL, rel[others].max()


def test_the_hidden_and_attention_output_are_not_rounded_to_bf16():
    """The Pallas kernel quantizes the fp32 attention output and the fp32
    hidden: the plain version's quantizers see fp32 values that are not
    bf16 values."""
    x, q8 = q8_inputs(seed=4, seq=5)
    seen = []
    row_quant = tfab._row_quant_i8

    def recording(h):
        seen.append(h)
        return row_quant(h)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(tfab, "_row_quant_i8", recording)
        tfab.fused_vit_block_q8_plain(*port_args(x, q8, "bfloat16"))
    for h in seen:
        assert h.dtype == torch.float32
        assert not torch.equal(h, h.bfloat16().float())


def test_wrapper_takes_plain_version_on_cpu():
    x, q8 = q8_inputs(seed=5, seq=5)
    before = tfab.fused_vit_block_q8.launches
    got = run_port(tfab.fused_vit_block_q8, x, q8, "bfloat16", group=2)
    want = run_port(tfab.fused_vit_block_q8_plain, x, q8, "bfloat16")
    np.testing.assert_array_equal(got, want)
    assert tfab.fused_vit_block_q8.launches == before
    with pytest.raises(ValueError, match="group"):
        run_port(tfab.fused_vit_block_q8, x, q8, "bfloat16", group=3)


# --- on the card: the CUDA kernel against the plain version -----------------

@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """ViT-B/32 widths on 8 images, one layer's weights from
    quantize_vision_blocks: within 1.6e-2 (|want| + rms(want)) with a
    relative Frobenius error of at most 2e-3 (a rare flipped code), one
    launch counted; fp32 x takes the fp32 form, one launch counted and an
    fp32 output (tests/test_torch_vit_q8_f32.py holds its values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_vit_block import cuda_layer

    cfg = tclip.CLIPVisionConfig.vit_b_32()
    x, layer = cuda_layer(cfg, 8)
    q8 = tclip.quantize_vision_blocks(
        {"blocks": {n: layer[n][None] for n in (
            "q", "k", "v", "o", "mlp_fc", "mlp_proj")}})
    q8 = {n: t[0] for n, t in q8.items()}
    q8["qkv_bias"] = torch.cat([layer[n + "_bias"] for n in "qkv"])
    args = (x, *(q8[n] if n in q8 else layer[n] for n in Q8_KEYS),
            cfg.num_heads)
    before = tfab.fused_vit_block_q8.launches
    got = tfab.fused_vit_block_q8(*args, group=4)
    torch.cuda.synchronize()
    assert tfab.fused_vit_block_q8.launches == before + 1
    g, p = got.float(), tfab.fused_vit_block_q8_plain(*args).float()
    assert bool(torch.isfinite(g).all())
    assert ((g - p).norm() / p.norm()).item() <= 2e-3
    rms = p.square().mean().sqrt()
    assert bool(((g - p).abs() <= 1.6e-2 * (p.abs() + rms)).all())
    before = tfab.fused_vit_block_q8.launches
    out = tfab.fused_vit_block_q8(x.float(), *args[1:], group=4)
    torch.cuda.synchronize()
    assert tfab.fused_vit_block_q8.launches == before + 1
    assert out.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("width,heads", kernel_probe.VIT_Q8_WIDTHS)
@pytest.mark.parametrize("batch", kernel_probe.VIT_Q8_BATCHES)
def test_cuda_kernel_sweep(batch, width, heads):
    """csrc/q8_gemm_tma.cuh's edges inside the block (kernel_probe
    --q8-variants' sweep): 1, 3 and 16 images (50, 150 and 800 rows: less
    than one 128-row tile, ragged last tiles), at ViT-B/32's widths (every
    product 256-column tiles) and at two narrower ones whose q | k | v and
    out-projection widths take 128-column tiles; within 1.6e-2 (|want| +
    rms(want)) of the plain version with a relative Frobenius error of at
    most 2e-3, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = kernel_probe.vit_block_q8_case(tclip.CLIPVisionConfig.vit_b_32(
        num_layers=1, width=width, num_heads=heads), batch)
    before = tfab.fused_vit_block_q8.launches
    got = tfab.fused_vit_block_q8(*args, group=1)
    torch.cuda.synchronize()
    assert tfab.fused_vit_block_q8.launches == before + 1
    g, p = got.float(), tfab.fused_vit_block_q8_plain(*args).float()
    assert bool(torch.isfinite(g).all())
    assert ((g - p).norm() / p.norm()).item() <= 2e-3
    rms = p.square().mean().sqrt()
    assert bool(((g - p).abs() <= 1.6e-2 * (p.abs() + rms)).all())
