"""The port's CLIP towers against the JAX package's on the same converted
params: the default path, fast_attention, the fused split3 path and the
whole-block branches (fused_vit_block, fused_vit_block_q8,
fused_attention_block; Pallas in interpret mode on the JAX side, the
kernels' plain versions on the port's), use_pallas (flash_attention), and
the text tower (the HF witness is in
tests/test_torch_clip_tools.py, which builds it once; the long-sequence
split* and fused_attention variants in tests/test_torch_clip_long.py; the
long int8 tower in tests/test_torch_clip_int8.py)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clip_text_params_from_numpy,
    clip_vision_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    attention as tflash,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the fp32 default path: the same ops, fp32 sums in another order
DEFAULT_TOL = 1e-5
# the fused path against JAX's same path: per-row cosine (both sides round
# to bf16 at the same places; a rounding that goes the other way moves an
# embedding by about a bf16 ulp)
SAME_PATH_COSINE = 0.99999
# the fused path against the default path: the JAX package's own bound
# (tests/test_vit_long_variants.py)
CROSS_PATH_COSINE = 0.999
# widths of each tower, for the JAX and the port config
TOWERS = {
    # seq (168 / 12)^2 + 1 = 197 > 128: the long-sequence branch
    "seq197": dict(image_size=168, patch_size=12, width=64, num_layers=2,
                   num_heads=4, projection_dim=32),
    "small_test": dict(image_size=28, patch_size=14, width=32, num_layers=2,
                       num_heads=4, projection_dim=16),
    # small_test(patch_size=4): (28 / 4)^2 + 1 = 50 tokens, ViT-B/32's length
    "seq50": dict(image_size=28, patch_size=4, width=32, num_layers=2,
                  num_heads=4, projection_dim=16),
    # (68 / 4)^2 + 1 = 290 > 256: flash_attention pads its query blocks
    "seq290": dict(image_size=68, patch_size=4, width=32, num_layers=2,
                   num_heads=4, projection_dim=16),
}
BATCH = 2


def configs(tower, dtype, **kw):
    jd, td = DTYPES[dtype]
    return (jclip.CLIPVisionConfig(**TOWERS[tower], dtype=jd, **kw),
            tclip.CLIPVisionConfig(**TOWERS[tower], dtype=td, **kw))


@pytest.fixture(scope="module")
def towers():
    """Each tower's params (fp32; drawn once, as numpy for JAX and through
    convert.py for the port, as a converted checkpoint would be) and the
    images."""
    out = {}
    for i, tower in enumerate(TOWERS):
        _, tcfg = configs(tower, "float32")
        tree = jax.tree.map(lambda t: t.numpy(), tclip.init_clip_vision_params(
            torch.Generator().manual_seed(i), tcfg, torch.float32))
        jp = jax.tree.map(jnp.asarray, tree)
        tp = clip_vision_params_from_numpy(tree, torch.float32, "cpu")
        rng = np.random.default_rng(10 + i)
        size = TOWERS[tower]["image_size"]
        images = rng.standard_normal((BATCH, size, size, 3)).astype(
            np.float32)
        out[tower] = (jp, tp, images)
    return out


_jax_cache = {}


def encode_jax(towers, tower, dtype, **kw):
    if kw.get("fused_block_long") == "" and tower == "seq197":
        kw["fused_block_long"] = "split3"   # the same JAX branch
    key = (tower, dtype, tuple(sorted(kw.items())))
    if key not in _jax_cache:
        jp, _, images = towers[tower]
        jcfg, _ = configs(tower, dtype, **kw)
        if kw.get("int8"):   # each side's blocks_q8 from its own quantizer
            jp = dict(jp, blocks_q8=jclip.quantize_vision_blocks(jp))
        _jax_cache[key] = np.asarray(jclip.clip_encode_image(
            jp, jcfg, jnp.asarray(images)).astype(jnp.float32))
    return _jax_cache[key]


def encode_port(towers, tower, dtype, **kw):
    _, tp, images = towers[tower]
    _, tcfg = configs(tower, dtype, **kw)
    if kw.get("int8"):
        tp = dict(tp, blocks_q8=tclip.quantize_vision_blocks(tp))
    out = tclip.clip_encode_image(tp, tcfg, torch.from_numpy(images))
    assert out.dtype == DTYPES[dtype][1]
    return out.float().numpy()


def cosine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("tower", list(TOWERS))
def test_default_path_fp32_matches_jax(towers, tower):
    want = encode_jax(towers, tower, "float32")
    got = encode_port(towers, tower, "float32")
    assert got.shape == (BATCH, TOWERS[tower]["projection_dim"])
    np.testing.assert_allclose(got, want, rtol=DEFAULT_TOL, atol=DEFAULT_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fast_attention_matches_jax(towers, dtype):
    """bf16 scores and PV: the same roundings on both sides."""
    want = encode_jax(towers, "seq197", dtype, fast_attention=True)
    got = encode_port(towers, "seq197", dtype, fast_attention=True)
    assert (cosine(got, want) >= SAME_PATH_COSINE).all()


SPLIT3_CASES = [("seq197", ""), ("seq197", "split3"),
                ("small_test", "split3")]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tower,variant", SPLIT3_CASES)
def test_split3_matches_jax_same_path(towers, tower, variant, dtype):
    kw = dict(fused_block=True, fused_block_long=variant)
    launches = [getattr(tfab, n).launches for n in (
        "fused_ln_qkv", "attention_core_oproj", "fused_mlp_block")]
    got = encode_port(towers, tower, dtype, **kw)
    # CPU tensors: the kernels' plain versions, no launch
    assert launches == [getattr(tfab, n).launches for n in (
        "fused_ln_qkv", "attention_core_oproj", "fused_mlp_block")]
    want = encode_jax(towers, tower, dtype, **kw)
    cos = cosine(got, want)
    assert (cos >= SAME_PATH_COSINE).all(), cos
    default = encode_jax(towers, tower, dtype)
    cross = cosine(got, default)
    assert (cross > CROSS_PATH_COSINE).all(), cross


def test_split3_is_not_the_default_path(towers):
    """The split3 path rounds h and hid to bf16 even in fp32: it is not
    the default path's arithmetic."""
    kw = dict(fused_block=True, fused_block_long="split3")
    fused = encode_port(towers, "seq197", "float32", **kw)
    default = encode_port(towers, "seq197", "float32")
    assert np.abs(fused - default).max() > 1e-4


def test_patch_embed_and_normalize_match_jax(towers):
    jp, tp, images = towers["seq197"]
    jcfg, tcfg = configs("seq197", "float32")
    np.testing.assert_allclose(
        tclip.patch_embed(tp, tcfg, torch.from_numpy(images)).numpy(),
        np.asarray(jclip.patch_embed(jp, jcfg, jnp.asarray(images))),
        rtol=DEFAULT_TOL, atol=DEFAULT_TOL)
    raw = np.random.default_rng(3).integers(0, 256, (2, 5, 7, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        tclip.normalize_images(torch.from_numpy(raw)).numpy(),
        np.asarray(jclip.normalize_images(jnp.asarray(raw))))


def test_init_params_have_the_jax_tree():
    for jinit, tinit, jcfg, tcfg in (
            (jclip.init_clip_vision_params, tclip.init_clip_vision_params,
             jclip.CLIPVisionConfig.small_test(),
             tclip.CLIPVisionConfig.small_test()),
            (jclip.init_clip_text_params, tclip.init_clip_text_params,
             jclip.CLIPTextConfig.small_test(),
             tclip.CLIPTextConfig.small_test())):
        jp = jax.eval_shape(lambda key: jinit(key, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
        tp = tinit(torch.Generator().manual_seed(0), tcfg, torch.float32)
        jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
        tflat = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
        assert jflat.keys() == tflat.keys()
        for key, leaf in jflat.items():
            assert tuple(tflat[key].shape) == leaf.shape, key
            assert tflat[key].dtype == torch.float32


def test_encode_text_matches_jax():
    jcfg, tcfg = jclip.CLIPTextConfig.small_test(), \
        tclip.CLIPTextConfig.small_test()
    jp = jclip.init_clip_text_params(jax.random.PRNGKey(7), jcfg, jnp.float32)
    tp = clip_text_params_from_numpy(jax.tree.map(np.asarray, jp),
                                     torch.float32, "cpu")
    ids = np.random.default_rng(1).integers(1, 90, (3, 12)).astype(np.int32)
    ids[0, 5] = ids[1, 11] = ids[2, 0] = 95        # EOT, the max id
    want = np.asarray(jclip.clip_encode_text(jp, jcfg, jnp.asarray(ids)))
    got = tclip.clip_encode_text(tp, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=DEFAULT_TOL, atol=DEFAULT_TOL)


# The branches of the whole-block kernels, each against JAX's same branch:
# the kernel each runs, whose launch count must not move on the CPU
WHOLE_BLOCK_CASES = [
    ("seq197", dict(fused_block=True, fused_block_long="whole"),
     "fused_vit_block"),
    ("seq197", dict(fused_block=True, fused_block_long="whole_dd"),
     "fused_vit_block"),
    ("small_test", dict(fused_block=True), "fused_vit_block"),
    ("small_test", dict(fused_block=True, fused_block_long="whole_fe"),
     "fused_vit_block"),
    ("small_test", dict(fused_attention=True), "fused_attention_block"),
    ("small_test", dict(int8=True), "fused_vit_block_q8"),
    ("seq50", dict(int8=True), "fused_vit_block_q8"),
]
# against the default path: the JAX package's bounds (the bf16 kernels',
# tests/test_vit_long_variants.py; the int8 blocks', tests/test_int8_vit.py)
QUANTIZED_COSINE = 0.995


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tower,kw,kernel", WHOLE_BLOCK_CASES,
                         ids=[f"{t}-{'-'.join(map(str, k.values()))}"
                              for t, k, _ in WHOLE_BLOCK_CASES])
def test_whole_block_branches_match_jax(towers, tower, kw, kernel, dtype):
    fn = getattr(tfab, kernel)
    before = fn.launches
    got = encode_port(towers, tower, dtype, **kw)
    assert fn.launches == before       # CPU tensors: the plain version
    want = encode_jax(towers, tower, dtype, **kw)
    cos = cosine(got, want)
    assert (cos >= SAME_PATH_COSINE).all(), cos
    cross = cosine(got, encode_jax(towers, tower, dtype))
    floor = QUANTIZED_COSINE if kw.get("int8") else CROSS_PATH_COSINE
    assert (cross > floor).all(), cross


def test_fused_attention_block_fp32_is_the_default_arithmetic(towers):
    """At 128 tokens or fewer fused_attention keeps the attention in fp32:
    in an fp32 tower it is the default path's arithmetic, to fp32 noise."""
    want = encode_jax(towers, "seq50", "float32", fused_attention=True)
    got = encode_port(towers, "seq50", "float32", fused_attention=True)
    np.testing.assert_allclose(got, want, rtol=DEFAULT_TOL, atol=DEFAULT_TOL)
    default = encode_port(towers, "seq50", "float32")
    np.testing.assert_allclose(got, default, rtol=DEFAULT_TOL,
                               atol=DEFAULT_TOL)


def test_unknown_long_variant_raises(towers):
    """The JAX package runs any other fused_block_long above 128 tokens as
    "split"; the port refuses it."""
    with pytest.raises(ValueError, match="split_c2fe"):
        encode_port(towers, "seq197", "float32", fused_block=True,
                    fused_block_long="splt")


def test_int8_without_blocks_q8_raises(towers):
    """The JAX package silently runs the bf16 blocks when cfg.int8 is set
    and the params hold no blocks_q8 (models/clip.py:497); the port
    raises, on the long and on the short int8 branch."""
    for tower in ("seq197", "seq50"):
        _, tp, images = towers[tower]
        _, tcfg = configs(tower, "float32", int8=True)
        with pytest.raises(ValueError, match="blocks_q8"):
            tclip.clip_encode_image(tp, tcfg, torch.from_numpy(images))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tower", ["small_test", "seq197", "seq290"])
def test_use_pallas_matches_jax(towers, tower, dtype):
    """use_pallas: the flash_attention kernel's plain version in the port,
    the Pallas kernel in interpret mode in JAX, at 5 tokens (Lk padded to
    128), 197 (Lk padded to 256) and 290 (Lk padded to 384, Lq to two
    256-row query blocks); the rest of the block as the default path runs
    it."""
    jp, tp, images = towers[tower]
    jcfg, tcfg = configs(tower, dtype)
    want = np.asarray(jclip.clip_encode_image(
        jp, jcfg, jnp.asarray(images), use_pallas=True).astype(jnp.float32))
    before = tflash.flash_attention.launches
    got = tclip.clip_encode_image(tp, tcfg, torch.from_numpy(images),
                                  use_pallas=True)
    assert tflash.flash_attention.launches == before   # CPU: plain version
    assert got.dtype == DTYPES[dtype][1]
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL)
    else:
        assert (cosine(got, want) >= SAME_PATH_COSINE).all(), \
            cosine(got, want)


def test_split3_group_does_not_change_the_result(towers):
    """fused_block_group only tiles the TPU grid: any group that divides
    the batch gives the same embeddings."""
    base = dict(fused_block=True, fused_block_long="split3")
    one = encode_port(towers, "small_test", "bfloat16",
                      fused_block_group=1, **base)
    two = encode_port(towers, "small_test", "bfloat16",
                      fused_block_group=2, **base)
    np.testing.assert_array_equal(one, two)
    with pytest.raises(ValueError, match="group"):
        encode_port(towers, "small_test", "bfloat16", fused_block_group=3,
                    **base)


def test_vision_config_presets():
    cfg = tclip.CLIPVisionConfig.vit_l_14_336()
    assert (cfg.seq_len, cfg.width, cfg.num_heads) == (577, 1024, 16)
    assert cfg.dtype == torch.bfloat16
    b32 = tclip.CLIPVisionConfig.vit_b_32()
    assert (b32.seq_len, b32.width) == (50, 768)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.width = 8
