"""The port's RICES (in_context_example_selection/) against the JAX
package's on the CPU, on synthetic caches and embeddings drawn from a seed
(the pattern of tests/test_knn_rices.py): each stage, run_full_pipeline and
the run_rices CLI write equal pickles (the same keys, question ids and
order, similarities within 1e-6), random.pkl is the JAX package's, stale
pickles raise, and a mesh wider than one card is refused."""

import json
import pickle
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu.in_context_example_selection import (  # noqa: E402
    make_random_examples as jrandom,
    rices as jrices,
    run_rices as jrun,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.in_context_example_selection import (  # noqa: E402
    make_random_examples as trandom,
    rices as trices,
    run_rices as trun,
)

SIM_TOL = 1e-6
DIM = 16


def assert_same(got, want, path="root"):
    """Equal trees, float arrays within SIM_TOL (and of one dtype)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), path
        for key in want:
            assert_same(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL,
                                   err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def make_items(n, qid_base, img_base, share=2):
    return [
        {
            "question_id": qid_base + i, "img_key": img_base + i // share,
            "question": f"q{i}", "gold_answer": f"a{i}",
        }
        for i in range(n)
    ]


def embeddings(rng, keys):
    return {str(k): rng.standard_normal((1, DIM)).astype(np.float32)
            for k in keys}


def synthetic(seed=2, n_train=40, n_val=9, share=3):
    """Train and val items (questions sharing images) and their four
    embedding pickles' dicts."""
    rng = np.random.default_rng(seed)
    train = make_items(n_train, 1000, 100, share)
    val = make_items(n_val, 5000, 500)
    return dict(
        train=train, val=val,
        train_text=embeddings(rng, [i["question_id"] for i in train]),
        val_text=embeddings(rng, [i["question_id"] for i in val]),
        train_img=embeddings(rng, dict.fromkeys(i["img_key"] for i in train)),
        val_img=embeddings(rng, dict.fromkeys(i["img_key"] for i in val)))


@pytest.fixture(scope="module")
def data():
    return synthetic()


@pytest.mark.parametrize("k", [8, 40, 64])
def test_question_knn_matches_jax(data, k):
    """k of 40 and 64: every train question (k clamped to N)."""
    want = jrices.question_knn(data["train_text"], data["val_text"], k=k)
    got = trices.question_knn(data["train_text"], data["val_text"], k=k,
                              device="cpu")
    assert_same(got, want)
    assert len(next(iter(got.values()))["question_ids"]) == min(k, 40)


@pytest.mark.parametrize("group_chunk", [2, 1024])
def test_image_knn_matches_jax(data, group_chunk):
    """Pools of different lengths (rows padded with their first candidate
    within a chunk), images shared by several questions (unique by first
    occurrence), a val question without neighbours skipped."""
    q_nns = jrices.question_knn(data["train_text"], data["val_text"], k=12)
    for i, item in enumerate(data["val"]):
        nns = q_nns[str(item["question_id"])]
        cut = 12 - (i % 4) * 3
        nns["question_ids"] = nns["question_ids"][:cut]
        nns["similarities"] = nns["similarities"][:cut]
    del q_nns[str(data["val"][-1]["question_id"])]
    args = (q_nns, data["train"], data["val"], data["train_img"],
            data["val_img"])
    want = jrices.image_knn_from_text_knn(*args, group_chunk=group_chunk)
    got = trices.image_knn_from_text_knn(*args, group_chunk=group_chunk,
                                         device="cpu")
    assert_same(got, want)
    assert len(got) == len(data["val"]) - 1


def test_image_knn_raises_on_stale_pickles(data):
    q_nns = {str(data["val"][0]["question_id"]): {
        "question_ids": [1000, 123456], "similarities": np.ones(2)}}
    args = (q_nns, data["train"], data["val"], data["train_img"],
            data["val_img"])
    with pytest.raises(KeyError, match="stale or mismatched"):
        jrices.image_knn_from_text_knn(*args)
    with pytest.raises(KeyError, match="stale or mismatched"):
        trices.image_knn_from_text_knn(*args, device="cpu")


@pytest.mark.parametrize("question_only", [False, True])
def test_joint_ranking_matches_jax(data, question_only):
    """The same stage inputs give the same lists, best example last."""
    q_nns = jrices.question_knn(data["train_text"], data["val_text"], k=20)
    i_nns = jrices.image_knn_from_text_knn(
        q_nns, data["train"], data["val"], data["train_img"], data["val_img"])
    args = (i_nns, q_nns, data["train"], data["val"])
    want = jrices.joint_ranking(*args, top_k=6, question_only=question_only)
    got = trices.joint_ranking(*args, top_k=6, question_only=question_only)
    assert got == want


def dump(obj, path):
    path.write_bytes(pickle.dumps(obj))
    return str(path)


def write_files(tmp_path, data):
    return {name: dump(data[name], tmp_path / f"{name}.pkl")
            for name in ("train_text", "val_text", "train_img", "val_img")}


@pytest.mark.parametrize("question_only", [False, True])
def test_run_full_pipeline_matches_jax(tmp_path, data, question_only):
    files = write_files(tmp_path, data)
    args = (files["train_text"], files["val_text"], files["train_img"],
            files["val_img"], data["train"], data["val"])
    want = jrices.run_full_pipeline(
        *args, str(tmp_path / "jax.pkl"), question_only=question_only,
        k_questions=16)
    got = trices.run_full_pipeline(
        *args, str(tmp_path / "port.pkl"), question_only=question_only,
        k_questions=16, device="cpu")
    assert got == want and len(got) == len(data["val"])
    with open(tmp_path / "port.pkl", "rb") as fh:
        assert pickle.load(fh) == want
    # best example last: the scores (float64) ascend along each list
    by_qid = {item["question_id"]: item for item in data["train"]}
    for item in data["val"]:
        examples = got[str(item["question_id"])]
        assert len(examples) == 16 if question_only else len(examples) <= 16
        scores = [cosine(data["val_text"][str(item["question_id"])],
                         data["train_text"][e["question_id"]])
                  + (0.0 if question_only else cosine(
                      data["val_img"][str(item["img_key"])],
                      data["train_img"][str(by_qid[int(e["question_id"])][
                          "img_key"])]))
                  for e in examples]
        assert np.all(np.diff(scores) >= -1e-6)


def cosine(a, b):
    a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_run_rices_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs with the same flags on caches wrapped as {"cache": ...}."""
    data = synthetic(seed=11, n_train=60, n_val=12)
    files = write_files(tmp_path, data)
    train_cache = dump({"cache": {"data_items": data["train"]}},
                       tmp_path / "train_cache.pkl")
    val_cache = dump({"data_items": data["val"]}, tmp_path / "val_cache.pkl")

    def flags(out):
        return ["--train_cache", train_cache, "--val_cache", val_cache,
                "--train_text_embeddings", files["train_text"],
                "--val_text_embeddings", files["val_text"],
                "--train_image_embeddings", files["train_img"],
                "--val_image_embeddings", files["val_img"],
                "--out", str(tmp_path / out), "--k_questions", "24"]

    monkeypatch.setattr(sys, "argv", ["run_rices"] + flags("jax.pkl"))
    jrun.main()
    trun.main(flags("port.pkl"), device="cpu")
    with open(tmp_path / "jax.pkl", "rb") as fh:
        want = pickle.load(fh)
    with open(tmp_path / "port.pkl", "rb") as fh:
        assert pickle.load(fh) == want
    assert len(want) == 12
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        trun.main(flags("mesh.pkl") + ["--mesh_data", "2"], device="cpu")


def test_random_pkl_equals_jax(tmp_path, monkeypatch):
    train = make_items(50, 1000, 100)
    train_cache = dump({"cache": {"data_items": train}},
                       tmp_path / "train_cache.pkl")
    questions = tmp_path / "val_questions.json"
    questions.write_text(json.dumps({"questions": [
        {"question_id": 7000 + i, "image_id": i} for i in range(9)]}))

    def flags(out):
        return ["--train_cache", train_cache, "--val_questions",
                str(questions), "--out", str(tmp_path / out),
                "--num_examples", "6", "--seed", "13"]

    monkeypatch.setattr(sys, "argv", ["make_random_examples"]
                        + flags("jax.pkl"))
    jrandom.main()
    trandom.main(flags("port.pkl"))
    want = (tmp_path / "jax.pkl").read_bytes()
    assert (tmp_path / "port.pkl").read_bytes() == want
    out = pickle.loads(want)
    assert len(out) == 9 and all(len(v) == 6 for v in out.values())
    assert trices.random_examples(train, [1, 2], 4, seed=5) == \
        jrices.random_examples(train, [1, 2], 4, seed=5)


def test_mesh_is_refused(data):
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        trices.question_knn(data["train_text"], data["val_text"], k=4,
                            mesh=-1, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        trices.image_knn_from_text_knn({}, data["train"], data["val"],
                                       data["train_img"], data["val_img"],
                                       mesh=8, device="cpu")


def test_rices_at_scale_chunk_matches_float64(capsys):
    """tools/rices_at_scale.py's four stages on one chunk against float64
    numpy (the question top-k, each candidate's image score, the joint top
    32), at a small size on the CPU; its CLI prints one JSON line."""
    import json as json_lib

    import torch

    from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (
        rices_at_scale,
    )

    flags = ["--n_train", "3000", "--n_val", "40", "--n_images", "400",
             "--dim", "32", "--k", "128", "--query_chunk", "16"]
    args = rices_at_scale.parse_args(flags)
    dev = torch.device("cpu")
    text, img, img_idx = rices_at_scale.make_database(args, dev)
    q_text, q_img = rices_at_scale.make_queries(args, 1, dev)
    sims, rows = rices_at_scale.rices_chunk(text, img, img_idx, q_text,
                                            q_img, args.k, args.top_examples)
    s1 = q_text.double().numpy() @ text.double().numpy().T
    q_idx = np.argsort(-s1, axis=1, kind="stable")[:, :args.k]
    s3 = q_img.double().numpy() @ img.double().numpy().T
    joint = (np.take_along_axis(s1, q_idx, 1)
             + np.take_along_axis(s3, img_idx.numpy()[q_idx], 1))
    pos = np.argsort(-joint, axis=1, kind="stable")[:, :args.top_examples]
    np.testing.assert_array_equal(rows.numpy(),
                                  np.take_along_axis(q_idx, pos, 1))
    np.testing.assert_allclose(sims.numpy(), np.take_along_axis(joint, pos, 1),
                               rtol=0, atol=1e-5)
    line = rices_at_scale.main(flags + ["--max_chunks", "2"], device="cpu")
    assert json_lib.loads(capsys.readouterr().out.strip()) == line
    assert line["value"] > 0 and line["device"]["name"] == "cpu"
    assert line["config"]["rows_shape"] == [32, 32]
