"""The tools' data meshes over four gloo CPU ranks (spawned once,
tests/torch_mesh_ranks.py) against one card's results and the JAX
package's (tests/test_knn_rices.py:250-310, tests/test_tools.py:292-320):

  * the sharded kNN (each rank a padded contiguous block of the database,
    a local top-k, the candidates gathered in (shard, local rank) order and
    merged) gives one card's indices: with k larger than a shard's rows,
    and with ties across shards (rows repeated in the database), which go
    to the lowest index as ``lax.top_k`` puts them;
  * the run_rices CLI with ``--mesh_data -1`` writes (on rank 0 only) the
    pickle one card writes, and JAX's;
  * the CLIP image and text encoders on the mesh (each rank a slice of
    each batch) give one card's embeddings within JAX's 1e-6;
  * a batch that the mesh does not divide, a --mesh_data that is not the
    world and one wider than it raise.
"""

import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu.in_context_example_selection import (  # noqa: E402
    rices as jrices,
)
from explicit_alignment_for_vqa_tasks_tpu.ops import knn as jknn  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.in_context_example_selection import (  # noqa: E402
    run_rices as trun,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import knn as tknn  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    clip_encoder as tenc,
)
from test_torch_rices import assert_same, dump, synthetic, write_files  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

WORLD = 4


def knn_cases():
    rng = np.random.default_rng(7)
    db = rng.standard_normal((37, 8)).astype(np.float32)    # 10 rows a rank
    queries = rng.standard_normal((11, 8)).astype(np.float32)
    tied = np.tile(rng.integers(-2, 3, (5, 4)).astype(np.float32), (6, 1))
    return [(queries, db, 5), (queries, db, 15), (tied[:7], tied, 9)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tools")
    data = synthetic(seed=4, n_train=45, n_val=10)
    files = write_files(tmp, data)
    caches = {"train": dump({"cache": {"data_items": data["train"]}},
                            tmp / "train_cache.pkl"),
              "val": dump({"data_items": data["val"]}, tmp / "val_cache.pkl")}

    def flags(out):
        return ["--train_cache", caches["train"], "--val_cache",
                caches["val"], "--train_text_embeddings", files["train_text"],
                "--val_text_embeddings", files["val_text"],
                "--train_image_embeddings", files["train_img"],
                "--val_image_embeddings", files["val_img"],
                "--out", str(tmp / out), "--k_questions", "20"]

    gen = torch.Generator().manual_seed(9)
    vision = tclip.init_clip_vision_params(
        gen, tclip.CLIPVisionConfig.small_test(), torch.float32)
    text = tclip.init_clip_text_params(
        gen, tclip.CLIPTextConfig.small_test(), torch.float32)
    tree = {"vision": ranks.numpy_tree(vision), "text": ranks.numpy_tree(text)}
    vcfg = tclip.CLIPVisionConfig.small_test()
    rng = np.random.default_rng(3)
    images = rng.standard_normal(
        (7, vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
    text_ids = rng.integers(1, 50, (3, tclip.CLIPTextConfig.small_test()
                                    .context_length)).astype(np.int32)
    got = ranks.run_ranks(ranks.tools_worker, WORLD, tmp / "ranks",
                          knn_cases(), flags("mesh.pkl") + [
                              "--mesh_data", "-1"],
                          tree, images, text_ids)
    trun.main(flags("one.pkl"), device="cpu")
    image_one = tenc.ClipImageEncoder(vcfg, vision, batch_size=4,
                                      device="cpu")
    text_one = tenc.ClipTextEncoder(tclip.CLIPTextConfig.small_test(), text,
                                    batch_size=4, device="cpu")
    one = {"image": np.concatenate([image_one.encode_batch(images[:4]),
                                    image_one.encode_batch(images[4:])]),
           "text": text_one.encode_ids(text_ids)}
    return dict(got=got, tmp=tmp, data=data, files=files, one=one)


def test_ranks_form_one_data_mesh(run):
    assert [r["mesh"] for r in run["got"]] == [{"data": WORLD,
                                                "model": 1}] * WORLD
    assert [r["data"] for r in run["got"]] == list(range(WORLD))


@pytest.mark.parametrize("case", range(3))
def test_sharded_knn_equals_one_card(run, case):
    queries, db, k = knn_cases()[case]
    sims, idx = tknn.knn_search(queries, db, k, device="cpu")
    jsims, jidx = jknn.knn_search(queries, db, k)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    for rec in run["got"]:
        got_sims, got_idx = rec["knn"][case]
        np.testing.assert_array_equal(got_idx, idx)
        np.testing.assert_allclose(got_sims, sims, rtol=0, atol=1e-6)


def test_rices_on_the_mesh_writes_one_cards_pickle(run):
    with open(run["tmp"] / "one.pkl", "rb") as fh:
        one = pickle.load(fh)
    with open(run["tmp"] / "mesh.pkl", "rb") as fh:
        assert_same(pickle.load(fh), one)
    files, data = run["files"], run["data"]
    want = jrices.run_full_pipeline(
        files["train_text"], files["val_text"], files["train_img"],
        files["val_img"], data["train"], data["val"],
        str(run["tmp"] / "jax.pkl"), k_questions=20)
    assert_same(one, want)


@pytest.mark.parametrize("kind", ["image", "text"])
def test_encoders_on_the_mesh_equal_one_card(run, kind):
    """Within 1e-6, JAX's rule for its mesh encoders (a rank's product of
    one row and one card's of four may sum in other orders); every rank
    returns the same embeddings."""
    for rec in run["got"]:
        np.testing.assert_allclose(rec[kind], run["one"][kind], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(rec[kind], run["got"][0][kind])


def test_undivided_batch_and_wrong_widths_raise(run):
    for rec in run["got"]:
        batch, narrow, wide = rec["errors"]
        assert "batch_size 6 must divide the mesh's data=4" in batch
        assert "--mesh_data 3 of 4 processes" in narrow
        assert "--mesh_data 8 > 4" in wide
