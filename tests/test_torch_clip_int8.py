"""The port's int8 CLIP image tower against the JAX package's: the
long-sequence int8 blocks (fused_qkv_q8, attention_core, the bf16
out-projection, fused_mlp_block_q8) at 197 tokens, its cosine to the
port's own unquantized tower, and convert.py's handling of the blocks_q8
tree."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clip_vision_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same codes on both sides, so only sums taken in another order
# differ (tests/test_torch_clip.py's default-path tolerance)
TOL = 1e-5
# bf16: both sides round to bf16 at the same places; a rounding that goes
# the other way moves an embedding by about a bf16 ulp
SAME_PATH_COSINE = 0.99999
# against the unquantized tower: the JAX package's own bound
# (tests/test_int8_vit.py)
QUANTIZED_COSINE = 0.995
# The pinned batch has no activation within MODEL_MARGIN (absolute, in code
# units: more than an fp32 ulp of the largest code, 127) of a .5 boundary,
# so the ulp or two by which the LayerNorm's sum order moves h cannot flip
# a code: the codes, and so the embeddings, agree with JAX's to fp32 noise.
# (At 197 tokens a batch holds about 150,000 activations; a margin much
# wider than this one leaves no batch clear of every boundary.)
MODEL_MARGIN = 1e-5
IMAGE_SEED = 4
BATCH = 2


def configs(dtype, **kw):
    """small_test at patch 2: (28 / 2)^2 + 1 = 197 tokens, the long-
    sequence int8 branch (as tests/test_int8_vit.py:65-81)."""
    jd, td = DTYPES[dtype]
    return (jclip.CLIPVisionConfig.small_test(patch_size=2, dtype=jd, **kw),
            tclip.CLIPVisionConfig.small_test(patch_size=2, dtype=td, **kw))


@pytest.fixture(scope="module")
def tower():
    """fp32 params drawn once (numpy for JAX, through convert.py for the
    port), each side's blocks_q8 from its own quantize_vision_blocks, and
    the pinned images."""
    _, tcfg = configs("float32")
    tree = jax.tree.map(lambda t: t.numpy(), tclip.init_clip_vision_params(
        torch.Generator().manual_seed(4), tcfg, torch.float32))
    jp = jax.tree.map(jnp.asarray, tree)
    jp["blocks_q8"] = jclip.quantize_vision_blocks(jp)
    tp = clip_vision_params_from_numpy(tree, torch.float32, "cpu")
    tp["blocks_q8"] = tclip.quantize_vision_blocks(tp)
    images = np.random.default_rng(IMAGE_SEED).standard_normal(
        (BATCH, 28, 28, 3)).astype(np.float32)
    return jp, tp, images


def encode_port(tp, images, dtype, **kw):
    _, tcfg = configs(dtype, **kw)
    return tclip.clip_encode_image(tp, tcfg, torch.from_numpy(images))


def cosine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def test_pinned_batch_has_no_activation_near_a_boundary(tower, monkeypatch):
    _, tp, images = tower
    codes = []
    row_quant = tfab._row_quant_i8

    def recording(h):
        q, s = row_quant(h)
        codes.append((h / s).numpy())
        return q, s

    monkeypatch.setattr(tfab, "_row_quant_i8", recording)
    encode_port(tp, images, "float32", int8=True)
    layers = tp["blocks"]["q"].shape[0]
    assert len(codes) == 3 * layers      # LN1, LN2 and the MLP hidden
    for t in codes:
        a = np.abs(t).astype(np.float64)
        assert np.abs(a - np.floor(a) - 0.5).min() >= MODEL_MARGIN


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_tower_matches_jax(tower, dtype):
    jp, tp, images = tower
    jcfg, _ = configs(dtype, int8=True)
    want = np.asarray(jclip.clip_encode_image(jp, jcfg, jnp.asarray(images))
                      .astype(jnp.float32))
    launches = [getattr(tfab, n).launches
                for n in ("fused_qkv_q8", "attention_core",
                          "fused_mlp_block_q8")]
    got = encode_port(tp, images, dtype, int8=True)
    assert got.dtype == DTYPES[dtype][1]
    assert launches == [getattr(tfab, n).launches
                        for n in ("fused_qkv_q8", "attention_core",
                                  "fused_mlp_block_q8")]
    got = got.float().numpy()
    assert got.shape == (BATCH, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert (cosine(got, want) >= SAME_PATH_COSINE).all()


def test_int8_tower_is_close_to_the_unquantized_tower(tower):
    _, tp, images = tower
    exact = encode_port(tp, images, "float32").numpy()
    int8 = encode_port(tp, images, "float32", int8=True).numpy()
    assert np.abs(int8 - exact).max() > 1e-4      # it is quantized
    assert (cosine(int8, exact) > QUANTIZED_COSINE).all()


def test_int8_uses_blocks_q8_not_the_bf16_projections(tower):
    """The int8 blocks read the quantized q, k, v and MLP weights (the
    out-projection stays bf16): zeroing the bf16 copies of the former
    leaves the embeddings as they were."""
    _, tp, images = tower
    want = encode_port(tp, images, "float32", int8=True)
    stripped = dict(tp)
    stripped["blocks"] = dict(tp["blocks"])
    for name in ("q", "k", "v", "mlp_fc", "mlp_proj"):
        stripped["blocks"][name] = torch.zeros_like(tp["blocks"][name])
    torch.testing.assert_close(
        encode_port(stripped, images, "float32", int8=True), want,
        rtol=0, atol=0)


def test_convert_keeps_the_int8_clip_tree():
    """A JAX tree with blocks_q8 converted at bf16: every *_scale under
    blocks_q8 stays fp32 and bit-equal, the codes stay int8 and bit-equal,
    and the LayerNorm scales (also named *_scale) are bf16."""
    jcfg = jclip.CLIPVisionConfig.small_test()
    jp = jclip.init_clip_vision_params(jax.random.PRNGKey(1), jcfg,
                                       jnp.float32)
    jp["blocks_q8"] = jclip.quantize_vision_blocks(jp)
    tree = jax.tree.map(np.asarray, jp)
    tp = clip_vision_params_from_numpy(tree, torch.bfloat16, "cpu")
    for key, leaf in tree["blocks_q8"].items():
        got = tp["blocks_q8"][key]
        if key.endswith("_scale"):
            assert got.dtype == torch.float32, key
        else:
            assert got.dtype == torch.int8, key
        np.testing.assert_array_equal(got.numpy(), leaf, err_msg=key)
    for key in ("ln1_scale", "ln2_scale"):
        assert tp["blocks"][key].dtype == torch.bfloat16
    for key in ("pre_ln_scale", "post_ln_scale"):
        assert tp[key].dtype == torch.bfloat16
    assert tp["blocks"]["q"].dtype == torch.bfloat16
