"""The port's fixture functions (tools/e2e_fixtures.py) against the JAX
package's tests/test_e2e.py: the files they write (JSON byte-equal, the
pickles and the parquet tables equal in value) and the configs they build
(equal as the port reads them), and the replication dryrun's artifacts,
which share the split writer, unchanged."""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    e2e_fixtures,
    replicate_dryrun,
)
import test_e2e  # noqa: E402
from test_torch_eval_data import port_config  # noqa: E402


def assert_values_equal(got, want):
    """Nested dicts and lists of numpy arrays and Python values, equal."""
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            assert_values_equal(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_values_equal(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("n_train,n_val", [(6, 4), (6, 32)])
def test_vqa_fixture_files_equal_jax(tmp_path, n_train, n_val):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = test_e2e.write_vqa_fixtures(tmp_path / "jax", n_train, n_val)
    got = e2e_fixtures.write_vqa_fixtures(tmp_path / "torch", n_train, n_val)
    assert sorted(got) == sorted(want)
    for key in ("train_q", "train_a", "val_q", "val_a"):
        with open(got[key], "rb") as g, open(want[key], "rb") as w:
            assert g.read() == w.read(), key
        assert json.loads(open(got[key]).read())
    for key in ("embeddings", "rices"):
        with open(got[key], "rb") as g, open(want[key], "rb") as w:
            assert_values_equal(pickle.load(g), pickle.load(w))


@pytest.mark.parametrize("additional", [
    {}, {"num_beams": 2}, {"pass_examples_through_encoder_one_at_a_time": 1},
    {"num_permutations_of_in_context_examples": 3}])
def test_test_config_equals_jax(tmp_path, additional):
    fixtures = test_e2e.write_vqa_fixtures(tmp_path)
    want = port_config(test_e2e.make_test_config(tmp_path, fixtures,
                                                 **additional), tmp_path)
    got = port_config(e2e_fixtures.make_test_config(tmp_path, fixtures,
                                                    **additional), tmp_path)
    assert got.to_dict() == want.to_dict()


def test_cc_config_and_rows_equal_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = test_e2e.TestConceptualCaptionsTraining().make_cc_config(
        tmp_path / "jax")
    got = e2e_fixtures.make_cc_config(tmp_path / "torch")
    module = "LoadConceptualCaptions"
    for split in ("train", "val"):
        paths = [c.data_loader.dataset_modules.module_dict[module].config[
            split] for c in (got, want)]
        assert paths[0] == str(tmp_path / "torch" / f"cc_{split}.parquet")
        tables = [pq.read_table(p) for p in paths]
        assert tables[0].schema == tables[1].schema
        assert tables[0].to_pylist() == tables[1].to_pylist()
    # the same config but for the folders the rows went to
    cfgs = [port_config(c, tmp_path).to_dict() for c in (got, want)]
    for cfg, folder in zip(cfgs, ("torch", "jax")):
        assert cfg["EXPERIMENT_FOLDER"] == str(tmp_path / folder /
                                               "experiments")
        cfg["EXPERIMENT_FOLDER"] = None
        cfg["data_loader"]["dataset_modules"]["module_dict"][module][
            "config"] = None
    assert cfgs[0] == cfgs[1]


def test_pickled_cc_rows_load_as_the_parquet_rows(tmp_path, monkeypatch):
    """Where pyarrow is absent, the rows go through
    PickledConceptualCaptions: the same rows, in order."""
    config = e2e_fixtures.make_cc_config(tmp_path)
    path = config.data_loader.dataset_modules.module_dict[
        "LoadConceptualCaptions"].config.train
    want = pq.read_table(path).to_pylist()
    monkeypatch.setattr(e2e_fixtures.importlib.util, "find_spec",
                        lambda name: None)
    (tmp_path / "x").mkdir()
    pickled = e2e_fixtures.make_cc_config(tmp_path / "x")
    assert pickled.data_loader.type == "PickledConceptualCaptions"
    loader = e2e_fixtures.DATA_LOADERS.get(pickled.data_loader.type)(pickled)
    loader.build_dataset()
    rows = loader.data.conceptual_captions
    for split in ("train", "val"):
        assert [rows[split][i] for i in range(len(rows[split]))] == want


def test_pickled_cc_loader_stays_out_of_the_registry_on_import():
    """Importing the fixtures registers no loader: the pickled one joins
    the registry only where make_cc_config writes pickles."""
    code = ("from explicit_alignment_for_vqa_tasks_tpu_torch.tools import "
            "e2e_fixtures\n"
            "from explicit_alignment_for_vqa_tasks_tpu_torch.registry import "
            "DATA_LOADERS\n"
            "assert 'PickledConceptualCaptions' not in DATA_LOADERS\n"
            "assert 'DataLoaderConceptualCaptions' in DATA_LOADERS\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_dryrun_artifacts_unchanged(tmp_path):
    """replicate_dryrun's artifacts: the split writer's files under the
    tool's names, and its three example pickles."""
    files = replicate_dryrun._write_vqa_artifacts(str(tmp_path / "d"))
    (tmp_path / "e").mkdir()
    want = test_e2e.write_vqa_fixtures(tmp_path / "e", 10, 4)
    for got_key, want_key in (("questions_train", "train_q"),
                              ("annotations_train", "train_a"),
                              ("questions_val", "val_q"),
                              ("annotations_val", "val_a"),
                              ("embeddings", "embeddings"),
                              ("rices", "rices")):
        with open(files[got_key], "rb") as g, open(want[want_key], "rb") as w:
            assert g.read() == w.read(), got_key
    with open(files["text_rices"], "rb") as fh:
        text_rices = pickle.load(fh)
    with open(files["random"], "rb") as fh:
        random_examples = pickle.load(fh)
    rices = pickle.loads(open(files["rices"], "rb").read())
    for qid, examples in rices.items():
        ids = [e["question_id"] for e in examples]
        assert [e["question_id"] for e in text_rices[qid]] == ids[::-1]
        assert sorted(e["question_id"] for e in random_examples[qid]) == \
            sorted(ids)
