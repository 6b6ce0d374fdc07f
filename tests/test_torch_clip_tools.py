"""The port's CLIP extraction tools against the JAX package's:
preprocess_image bit-equal, ClipImageEncoder's padding and order, the int8
encoder, extract() of both packages on a few JPEGs (same keys, values,
checkpoints; bf16 blocks and int8), the refused options; and an HF CLIP
built from a local config as a third witness of the CLIP towers, their
converters and the encoders' loading of local HF weights (built once here,
for the whole module)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    clip_encoder as jenc,
)
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    extract_contrastive_image_embeddings as jext,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clip_text_params_from_numpy,
    clip_vision_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    clip_encoder as tenc,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    extract_contrastive_image_embeddings as text_,
)
from test_torch_clip_int8 import (  # noqa: E402
    IMAGE_SEED,
    configs as seq197_configs,
)

# fp32 default path of both packages: the same ops, fp32 sums in another
# order (tests/test_torch_clip.py)
TOL = 1e-5
# a code flipped at a .5 boundary, or a bf16 rounding inside a fused block
# that goes the other way, moves an embedding far less than this
INT8_SAME_PATH_COSINE = 0.99999
HF_TOL = 2e-4


@pytest.fixture(scope="module")
def small():
    """small_test configs of both packages and one fp32 weight tree."""
    tcfg = tclip.CLIPVisionConfig.small_test()
    tree = jax.tree.map(lambda t: t.numpy(), tclip.init_clip_vision_params(
        torch.Generator().manual_seed(3), tcfg, torch.float32))
    return (jclip.CLIPVisionConfig.small_test(), jax.tree.map(jnp.asarray, tree),
            tcfg, clip_vision_params_from_numpy(tree, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def seq197():
    """The int8 tower of tests/test_torch_clip_int8.py: 197-token configs of
    both packages and one fp32 weight tree (the weights whose pinned batch
    has no activation near a code boundary)."""
    jcfg, tcfg = seq197_configs("float32")
    tree = jax.tree.map(lambda t: t.numpy(), tclip.init_clip_vision_params(
        torch.Generator().manual_seed(4), tcfg, torch.float32))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            clip_vision_params_from_numpy(tree, torch.float32, "cpu"))


IMAGES = {
    "rgb_non_square": (37, 53, 3),
    "gray": (30, 30),
    "rgba": (41, 29, 4),
    "small_upscaled": (9, 12, 3),
}


@pytest.mark.parametrize("kind", list(IMAGES))
def test_preprocess_image_is_bit_equal_to_jax(kind):
    image = np.random.default_rng(len(kind)).integers(
        0, 256, IMAGES[kind], dtype=np.uint8)
    want = jenc.preprocess_image(image, 28)
    got = tenc.preprocess_image(image, 28)
    assert got.dtype == np.float32 and got.shape == (28, 28, 3)
    np.testing.assert_array_equal(got, want)


def test_encode_batch_pads_the_last_batch(small):
    _, _, tcfg, tp = small
    encoder = tenc.ClipImageEncoder(tcfg, tp, batch_size=4, device="cpu")
    images = np.random.default_rng(0).standard_normal(
        (3, 28, 28, 3)).astype(np.float32)
    got = encoder.encode_batch(images)
    assert got.shape == (3, tcfg.projection_dim) and got.dtype == np.float32
    padded = np.concatenate([images, np.zeros((1, 28, 28, 3), np.float32)])
    want = tclip.clip_encode_image(tp, tcfg, torch.from_numpy(padded))
    np.testing.assert_array_equal(got, want[:3].numpy())
    # a tensor batch goes the same way
    np.testing.assert_array_equal(
        encoder.encode_batch(torch.from_numpy(images)), got)


def test_encode_iter_keeps_the_order(small):
    _, _, tcfg, tp = small
    encoder = tenc.ClipImageEncoder(tcfg, tp, batch_size=3, device="cpu")
    rng = np.random.default_rng(1)
    items = [(f"k{i}", rng.standard_normal((28, 28, 3)).astype(np.float32))
             for i in range(7)]
    out = list(encoder.encode_iter(iter(items)))
    assert [k for k, _ in out] == [k for k, _ in items]
    want = encoder.encode_batch(np.stack([im for _, im in items[3:6]]))
    np.testing.assert_array_equal(np.stack([e for _, e in out[3:6]]), want)


def test_encoders_refuse_what_is_not_ported(small):
    _, _, tcfg, tp = small
    # the extraction mesh is over processes: one process has no second
    # rank (tests/test_torch_mesh_tools.py encodes over four)
    with pytest.raises(ValueError, match="--mesh_data 2 > 1"):
        tenc.ClipImageEncoder(tcfg, tp, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="--mesh_data 4 > 1"):
        tenc.ClipTextEncoder(tclip.CLIPTextConfig.small_test(), params={},
                             mesh=4, device="cpu")


def test_int8_encoder_matches_jax(seq197):
    """ClipImageEncoder(int8=True) quantizes into a copy of the caller's
    dict, sets cfg.int8, and encodes the pinned batch (padded to the batch
    size) as JAX's int8 encoder does."""
    jcfg, jp, tcfg, tp = seq197
    encoders = (jenc.ClipImageEncoder(jcfg, jp, batch_size=4, int8=True),
                tenc.ClipImageEncoder(tcfg, tp, batch_size=4, int8=True,
                                      device="cpu"))
    assert "blocks_q8" not in jp and "blocks_q8" not in tp
    assert encoders[1].cfg.int8 and not tcfg.int8
    assert encoders[1].params["blocks"] is tp["blocks"]
    assert encoders[1].params["blocks_q8"]["qkv"].dtype == torch.int8
    images = np.random.default_rng(IMAGE_SEED).standard_normal(
        (2, 28, 28, 3)).astype(np.float32)
    want, got = (e.encode_batch(images) for e in encoders)
    assert got.shape == (2, tcfg.projection_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_vit_b32_shaped_fused_encoder_matches_jax(int8):
    """A 50-token tower (small_test at patch 4: ViT-B/32's sequence length)
    with fused_block=True, as bench.py builds ViT-B/32, and with int8=True
    on top of it (the int8 branch wins, as in JAX): ClipImageEncoder of both
    packages on the same fp32 weights and images, the batch padded to the
    encoder's size; each row's cosine to JAX's (both sides round to bf16
    at the same places inside the blocks)."""
    jcfg = jclip.CLIPVisionConfig.small_test(patch_size=4, fused_block=True)
    tcfg = tclip.CLIPVisionConfig.small_test(patch_size=4, fused_block=True)
    assert tcfg.seq_len == 50
    tree = jax.tree.map(lambda t: t.numpy(), tclip.init_clip_vision_params(
        torch.Generator().manual_seed(5), tcfg, torch.float32))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = clip_vision_params_from_numpy(tree, torch.float32, "cpu")
    encoders = (jenc.ClipImageEncoder(jcfg, jp, batch_size=4, int8=int8),
                tenc.ClipImageEncoder(tcfg, tp, batch_size=4, int8=int8,
                                      device="cpu"))
    assert "blocks_q8" not in tp and encoders[1].cfg.int8 == int8
    kernel = tfab.fused_vit_block_q8 if int8 else tfab.fused_vit_block
    before = kernel.launches
    images = np.random.default_rng(6).standard_normal(
        (3, 28, 28, 3)).astype(np.float32)
    want, got = (e.encode_batch(images) for e in encoders)
    assert kernel.launches == before       # CPU tensors: the plain version
    assert got.shape == (3, tcfg.projection_dim) and got.dtype == np.float32
    cosine = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                     * np.linalg.norm(want, axis=-1))
    assert (cosine >= INT8_SAME_PATH_COSINE).all(), cosine


def test_encoders_without_weights_draw_seed_0(monkeypatch, caplog):
    """No params and no local HF weights: a warning and random weights
    from seed 0, the same for every encoder built so."""
    for cls in (tenc.ClipImageEncoder, tenc.ClipTextEncoder):
        monkeypatch.setattr(cls, "_try_load_hf", lambda *a: None)
    monkeypatch.setattr(tenc.ClipTextEncoder, "_try_load_tokenizer",
                        lambda *a: None)
    cfg = tclip.CLIPVisionConfig.small_test()
    with caplog.at_level("WARNING"):
        a = tenc.ClipImageEncoder(cfg, device="cpu")
    assert "random init" in caplog.text
    b = tenc.ClipImageEncoder(cfg, device="cpu")
    for key in ("projection", "class_embedding"):
        assert torch.equal(a.params[key], b.params[key])
    assert a.params["projection"].dtype == torch.bfloat16
    text = tenc.ClipTextEncoder(tclip.CLIPTextConfig.small_test(),
                                batch_size=4, device="cpu")
    ids = np.array([[5, 7, 95, 0], [9, 95, 0, 0]], np.int32)
    got = text.encode_ids(ids)
    want = tclip.clip_encode_text(
        text.params, text.cfg,
        torch.from_numpy(np.concatenate([ids, np.zeros_like(ids)])))
    np.testing.assert_array_equal(got, want[:2].float().numpy())
    with pytest.raises(RuntimeError, match="tokenizer"):
        text.tokenize(["a photo"])


def write_images(root, ids, subtype):
    from PIL import Image

    rng = np.random.default_rng(2)
    for i in ids:
        pixels = rng.integers(0, 256, (24 + i % 5, 31, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(
            os.path.join(root, f"COCO_{subtype}_{str(i).zfill(12)}.jpg"))


def spy_checkpoints(encoder, out_path, seen):
    """Record how many embeddings the pickle on disk holds each time the
    encoder yields one (the checkpoints written so far)."""
    encode_iter = encoder.encode_iter

    def spying(items):
        for pair in encode_iter(items):
            if os.path.exists(out_path):
                with open(out_path, "rb") as fh:
                    seen.append(len(pickle.load(fh)))
            else:
                seen.append(0)
            yield pair

    encoder.encode_iter = spying


def test_extract_matches_jax(small, tmp_path):
    assert_extract_matches_jax(*small, tmp_path, int8=False)


def test_extract_int8_matches_jax(seq197, tmp_path):
    """The int8 tower, each encoder built with int8=True as --int8 builds
    it."""
    assert_extract_matches_jax(*seq197, tmp_path, int8=True)


def assert_extract_matches_jax(jcfg, jp, tcfg, tp, tmp_path, int8):
    """extract() of both packages on the same JPEGs: the same keys, values
    and checkpoints."""
    ids = [3, 11, 42, 7, 19]
    write_images(str(tmp_path), ids, "val2014")
    questions = [{"image_id": i, "question_id": n}
                 for n, i in enumerate(ids + [11, 3, 999])]   # 999: missing
    qfile = tmp_path / "questions.json"
    qfile.write_text(json.dumps({"questions": questions}))
    results, seen = {}, {}
    for name, module, encoder in (
            ("jax", jext, jenc.ClipImageEncoder(jcfg, jp, batch_size=2,
                                                int8=int8)),
            ("port", text_, tenc.ClipImageEncoder(tcfg, tp, batch_size=2,
                                                  int8=int8, device="cpu"))):
        out = tmp_path / f"{name}.pkl"
        seen[name] = []
        spy_checkpoints(encoder, str(out), seen[name])
        module.extract(str(qfile), str(tmp_path), "val2014", str(out),
                       checkpoint_every=2, encoder=encoder)
        with open(out, "rb") as fh:
            results[name] = pickle.load(fh)
    want, got = results["jax"], results["port"]
    assert list(got) == list(want) == [str(i) for i in sorted(ids)]
    for key, emb in want.items():
        assert got[key].shape == emb.shape == (1, tcfg.projection_dim)
        assert got[key].dtype == np.float32
        if int8:
            # these JPEGs hold activations within an fp32 ulp of a .5 code
            # boundary, where a code may round the other way: per-row
            # cosine (test_int8_encoder_matches_jax holds a pinned batch
            # clear of the boundaries to TOL)
            a, b = got[key][0].astype(np.float64), emb[0].astype(np.float64)
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) \
                >= INT8_SAME_PATH_COSINE
        else:
            np.testing.assert_allclose(got[key], emb, rtol=TOL, atol=TOL)
    assert seen["port"] == seen["jax"] == [0, 0, 2, 2, 4]


# --- HF CLIP built from a local config: a third witness ---------------------

@pytest.fixture(scope="module")
def hf_models():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    vision = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14,
            projection_dim=16, hidden_act="quick_gelu",
            attention_dropout=0.0)).eval()
    text = transformers.CLIPTextModelWithProjection(
        transformers.CLIPTextConfig(
            vocab_size=96, hidden_size=32, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16, projection_dim=16,
            hidden_act="quick_gelu", attention_dropout=0.0,
            eos_token_id=95, bos_token_id=94)).eval()
    return vision, text


def test_hf_convert_equals_jax_trees(hf_models):
    from explicit_alignment_for_vqa_tasks_tpu.models import (
        hf_convert as jconv,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import (
        hf_convert as tconv,
    )

    vision, text = hf_models
    for conv, model, cfg in (
            ("clip_vision_params_from_hf", vision,
             tclip.CLIPVisionConfig.small_test()),
            ("clip_text_params_from_hf", text,
             tclip.CLIPTextConfig.small_test())):
        sd = model.state_dict()
        want = dict(jax.tree_util.tree_flatten_with_path(
            getattr(jconv, conv)(sd, cfg))[0])
        got = dict(jax.tree_util.tree_flatten_with_path(
            getattr(tconv, conv)(sd, cfg))[0])
        assert want.keys() == got.keys()
        for key, leaf in want.items():
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], leaf)


def test_image_embeddings_match_hf(hf_models):
    from explicit_alignment_for_vqa_tasks_tpu_torch.models.hf_convert import (
        clip_vision_params_from_hf,
    )

    vision, _ = hf_models
    cfg = tclip.CLIPVisionConfig.small_test()
    params = clip_vision_params_from_numpy(
        clip_vision_params_from_hf(vision.state_dict(), cfg), torch.float32,
        "cpu")
    images = np.random.default_rng(0).standard_normal(
        (2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        want = vision(pixel_values=torch.from_numpy(
            images.transpose(0, 3, 1, 2))).image_embeds.numpy()
    got = tclip.clip_encode_image(params, cfg, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=HF_TOL, atol=HF_TOL)


def test_text_embeddings_match_hf(hf_models):
    from explicit_alignment_for_vqa_tasks_tpu_torch.models.hf_convert import (
        clip_text_params_from_hf,
    )

    _, text = hf_models
    cfg = tclip.CLIPTextConfig.small_test()
    params = clip_text_params_from_numpy(
        clip_text_params_from_hf(text.state_dict(), cfg), torch.float32,
        "cpu")
    ids = np.random.default_rng(1).integers(1, 90, size=(2, 10))
    ids[0, 6] = ids[1, 9] = 95
    with torch.no_grad():
        want = text(input_ids=torch.from_numpy(ids)).text_embeds.numpy()
    got = tclip.clip_encode_text(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=HF_TOL, atol=HF_TOL)


def test_encoders_load_local_hf_weights(hf_models, tmp_path):
    """Given a local HF checkpoint, the encoders load it (no download) and
    encode as the HF models do."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.tools.clip_encoder import (
        ClipImageEncoder,
        ClipTextEncoder,
    )

    vision, text = hf_models
    vision.save_pretrained(tmp_path / "vision")
    text.save_pretrained(tmp_path / "text")
    images = np.random.default_rng(4).standard_normal(
        (3, 28, 28, 3)).astype(np.float32)
    encoder = ClipImageEncoder(tclip.CLIPVisionConfig.small_test(),
                               model_version=str(tmp_path / "vision"),
                               batch_size=4, param_dtype=torch.float32,
                               device="cpu")
    with torch.no_grad():
        want = vision(pixel_values=torch.from_numpy(
            images.transpose(0, 3, 1, 2))).image_embeds.numpy()
    np.testing.assert_allclose(encoder.encode_batch(images), want,
                               rtol=HF_TOL, atol=HF_TOL)
    text_encoder = ClipTextEncoder(tclip.CLIPTextConfig.small_test(),
                                   model_version=str(tmp_path / "text"),
                                   batch_size=4, param_dtype=torch.float32,
                                   device="cpu")
    ids = np.random.default_rng(5).integers(1, 90, size=(2, 10))
    ids[:, -1] = 95
    with torch.no_grad():
        want = text(input_ids=torch.from_numpy(ids)).text_embeds.numpy()
    np.testing.assert_allclose(text_encoder.encode_ids(ids), want,
                               rtol=HF_TOL, atol=HF_TOL)
