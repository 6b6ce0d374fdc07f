"""The port's text and Conceptual Captions extractors against the JAX
package's on the CPU: extract_contrastive_text_embeddings.extract writes
JAX's {str(qid): float32 [1, proj_dim]} pickle (a tiny CLIPTextConfig with
converted weights, one stand-in tokenizer for both); the Conceptual
Captions extract_rows, with a stand-in fetch (no network), writes JAX's
parquet schema and rows; its main() builds the int8 encoder for --int8 and
refuses a mesh wider than the world of processes."""

import json
import pickle
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    clip_encoder as jenc,
    extract_clip_embeddings_conceptual_captions as jcc,
    extract_contrastive_text_embeddings as jtext,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clip_text_params_from_numpy,
    clip_vision_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    clip_encoder as tenc,
    extract_clip_embeddings_conceptual_captions as tcc,
    extract_contrastive_text_embeddings as ttext,
)

# fp32 towers of both packages: the same ops, sums in another order
TOL = 1e-5


class WordTokenizer:
    """A stand-in for the HF CLIP tokenizer: start 1, one id per word (its
    letters' sum, below 90), end 95 (the largest id: CLIP pools there),
    zero padding to max_length."""

    def __call__(self, texts, padding, max_length, truncation,
                 return_tensors):
        assert padding == "max_length" and truncation
        ids = np.zeros((len(texts), max_length), np.int64)
        for row, text in enumerate(texts):
            words = [3 + sum(map(ord, w)) % 87 for w in text.split()]
            tokens = ([1] + words)[:max_length - 1] + [95]
            ids[row, :len(tokens)] = tokens
        return {"input_ids": ids}


def test_text_extract_matches_jax(tmp_path, monkeypatch):
    for cls in (jenc.ClipTextEncoder, tenc.ClipTextEncoder):
        monkeypatch.setattr(cls, "_try_load_tokenizer",
                            lambda *a: WordTokenizer())
    jcfg = jclip.CLIPTextConfig.small_test()
    jp = jclip.init_clip_text_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = clip_text_params_from_numpy(jax.tree.map(np.asarray, jp),
                                     torch.float32, "cpu")
    words = ("what", "color", "is", "the", "dog", "cat", "sky", "how",
             "many", "people", "are", "there", "in", "this", "photo")
    rng = np.random.default_rng(0)
    questions = [{"question_id": 4000 + 7 * i, "image_id": i,
                  "question": " ".join(rng.choice(words, 3 + i % 9)) + "?"}
                 for i in range(11)]
    qfile = tmp_path / "questions.json"
    qfile.write_text(json.dumps({"questions": questions}))
    jtext.extract(str(qfile), str(tmp_path / "jax.pkl"), batch_size=4,
                  encoder=jenc.ClipTextEncoder(jcfg, jp, batch_size=4))
    got = ttext.extract(
        str(qfile), str(tmp_path / "port.pkl"), batch_size=4,
        encoder=tenc.ClipTextEncoder(tclip.CLIPTextConfig.small_test(), tp,
                                     batch_size=4, device="cpu"))
    with open(tmp_path / "jax.pkl", "rb") as fh:
        want = pickle.load(fh)
    with open(tmp_path / "port.pkl", "rb") as fh:
        assert list(pickle.load(fh)) == list(got)
    assert list(got) == list(want) == [str(q["question_id"])
                                       for q in questions]
    for key, emb in want.items():
        assert got[key].dtype == np.float32
        assert got[key].shape == emb.shape == (1, jcfg.projection_dim)
        np.testing.assert_allclose(got[key], emb, rtol=TOL, atol=TOL)


def fake_fetch(url):
    """A URL's image drawn from its digits; ``.../missing...`` fails, as a
    dead link does."""
    if "missing" in url:
        return None
    seed = int("".join(c for c in url if c.isdigit()))
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (20 + seed % 13, 31, 3), dtype=np.uint8)


def test_conceptual_captions_rows_match_jax(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    tcfg = tclip.CLIPVisionConfig.small_test()
    tree = jax.tree.map(lambda t: t.numpy(), tclip.init_clip_vision_params(
        torch.Generator().manual_seed(5), tcfg, torch.float32))
    rows = [{"image_url": f"http://images/{i}.jpg" if i % 4 != 2 else
             f"http://images/missing{i}.jpg",
             "caption": f"a dog on a bench number {i}" + ("." if i % 2
                                                          else " ")}
            for i in range(9)]
    for name, module, encoder in (
            ("jax", jcc, jenc.ClipImageEncoder(
                jclip.CLIPVisionConfig.small_test(),
                jax.tree.map(jnp.asarray, tree), batch_size=4)),
            ("port", tcc, tenc.ClipImageEncoder(
                tcfg, clip_vision_params_from_numpy(tree, torch.float32,
                                                    "cpu"),
                batch_size=4, device="cpu"))):
        written = module.extract_rows(rows, str(tmp_path / f"{name}.parquet"),
                                      encoder=encoder, batch_size=4,
                                      num_threads=3, fetch=fake_fetch)
        assert written == 7
    want = pq.read_table(tmp_path / "jax.parquet")
    got = pq.read_table(tmp_path / "port.parquet")
    assert got.schema == want.schema
    assert got.column_names == ["image_url", "caption", "clip_embeddings"]
    for column in ("image_url", "caption"):
        assert got[column].to_pylist() == want[column].to_pylist()
    assert got["caption"].to_pylist()[1] == ["a dog on a bench number 1 ."]
    np.testing.assert_allclose(
        np.asarray(got["clip_embeddings"].to_pylist(), np.float32),
        np.asarray(want["clip_embeddings"].to_pylist(), np.float32),
        rtol=TOL, atol=TOL)
    for caption in ("a cat.", " a cat . ", "a cat"):
        assert tcc.normalize_caption(caption) == \
            jcc.normalize_caption(caption) == "a cat ."


def test_conceptual_captions_main_builds_the_int8_encoder(tmp_path,
                                                          monkeypatch):
    """main() with a stand-in ``datasets`` module: --int8 builds
    ClipImageEncoder(int8=True), --limit cuts the rows, --mesh_data 2
    raises in one process, which has no second rank to shard over."""
    data = [{"image_url": f"u{i}", "caption": f"c{i}"} for i in range(5)]

    class Split(list):
        def select(self, indices):
            return Split(self[i] for i in indices)

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=lambda name, split: Split(data)))
    built, extracted = [], []

    class Encoder:
        def __init__(self, **kwargs):
            tenc._check_mesh(kwargs["mesh"])
            built.append(kwargs)

    monkeypatch.setattr(tcc, "ClipImageEncoder", Encoder)
    monkeypatch.setattr(tcc, "extract_rows",
                        lambda rows, out, **kw: extracted.append((rows, kw)))
    monkeypatch.setattr(sys, "argv", [
        "extract", "--out", str(tmp_path / "cc.parquet"), "--int8",
        "--limit", "3", "--batch_size", "8"])
    tcc.main()
    assert built == [{"batch_size": 8, "int8": True, "mesh": 1}]
    rows, kw = extracted[0]
    assert rows == data[:3] and kw["batch_size"] == 8
    monkeypatch.setattr(sys, "argv", [
        "extract", "--out", str(tmp_path / "cc.parquet"), "--mesh_data", "2"])
    with pytest.raises(ValueError, match="--mesh_data 2 > 1"):
        tcc.main()
