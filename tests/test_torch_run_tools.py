"""The port's run tools against the JAX package's on the CPU:
generate_captions on a tiny VC-T0 with the committed tokenizer fixture,
replicate_baseline's configs, artifact checklist and report, the analysis
tools (answer lengths, report plots, the in-context example grid) and
device_stats (the dryrun through the harness: tests/test_torch_replicate.py)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.data import tokenization as jtok  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    answer_length_analysis as j_answers,
    generate_captions as j_captions,
    replicate_baseline as j_rb,
    report_plots as j_plots,
    visualise_in_context_examples as j_vis,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.data import tokenization as ttok  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import mappers as tmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    answer_length_analysis as t_answers,
    generate_captions as t_captions,
    replicate_baseline as t_rb,
    report_plots as t_plots,
    visualise_in_context_examples as t_vis,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import device_stats  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_t5_tokenizer")
MAPPER = dict(mapping_type="mlp", prefix_size=8, d_model=32,
              prefix_length=2, clip_length=2)


@pytest.fixture(scope="module")
def caption_models():
    """A tiny VC-T0 in both packages on JAX's params, its sentinel the
    fixture tokenizer's <extra_id_0>, and each package's tokenizer."""
    with open(os.path.join(FIXTURE, "fixture_meta.json")) as fh:
        sentinel = json.load(fh)["sentinel_base"]
    jcfg = jvct0.VCT0Config(lm=jt5.T5Config.small_test(),
                            mapper=jmap.MapperConfig(**MAPPER),
                            sentinel_base=sentinel)
    tcfg = tvct0.VCT0Config(lm=tt5.T5Config.small_test(),
                            mapper=tmap.MapperConfig(**MAPPER),
                            sentinel_base=sentinel)
    jp = jvct0.init_vct0_params(jax.random.PRNGKey(0), jcfg,
                                param_dtype=jnp.float32)
    tp = vct0_params_from_numpy(jax.tree.map(np.asarray, jp), torch.float32,
                                "cpu")
    return ((jvct0.VCT0Model(jcfg, jp),
             jtok.load_tokenizer("T5TokenizerFast", FIXTURE)),
            (tvct0.VCT0Model(tcfg, tp),
             ttok.load_tokenizer("T5TokenizerFast", FIXTURE)))


@pytest.mark.parametrize("forced_prefix", ["A picture of", None])
def test_generate_captions_equal_jax(caption_models, forced_prefix):
    """Five embeddings in batches of 2 (a ragged last batch): the same
    strings as JAX's, with and without the forced prefix."""
    (jmodel, jtokenizer), (tmodel, ttokenizer) = caption_models
    embeddings = np.random.default_rng(0).standard_normal((5, 8)).astype(
        np.float32)
    kw = dict(forced_prefix=forced_prefix, max_new_tokens=5, batch_size=2)
    want = j_captions.generate_captions(jmodel, jtokenizer, embeddings, **kw)
    got = t_captions.generate_captions(tmodel, ttokenizer, embeddings, **kw)
    assert got == want and len(got) == 5
    if forced_prefix:
        assert all(c.startswith("A picture of") for c in got)


def test_read_embeddings_pickle_and_parquet(tmp_path):
    """The CLI's two embedding files, in the JAX CLI's row order."""
    pq = pytest.importorskip("pyarrow.parquet")
    import pyarrow as pa

    rows = np.random.default_rng(1).standard_normal((4, 1, 6)).astype(
        np.float32)
    path = tmp_path / "e.pkl"
    path.write_bytes(pickle.dumps({str(i): r for i, r in enumerate(rows)}))
    np.testing.assert_array_equal(
        t_captions.read_embeddings(str(path), 3), rows[:3, 0])
    table = pa.table({"clip_embeddings": [r.tolist() for r in rows]})
    pq.write_table(table, tmp_path / "e.parquet")
    np.testing.assert_array_equal(
        t_captions.read_embeddings(str(tmp_path / "e.parquet"), 10),
        rows[:, 0])


def test_generate_captions_cli_on_the_cpu(tmp_path):
    """The CLI on the shipped config at the T5_test size with the fixture
    tokenizer and a save_checkpoint mapper: one caption an embedding, each
    the forced prefix and what generate_captions gives on the same model,
    written to --out; generate_s is the call's time."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (
        checkpointing,
        model_factory,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.utils import (
        config_system,
    )

    config_file = os.path.join(REPO, "configs", "vqa2",
                               "few_shot_vqa_hotpotqa.jsonnet")
    with open(os.path.join(FIXTURE, "fixture_meta.json")) as fh:
        sentinel = json.load(fh)["sentinel_base"]
    opts = ["model_config.TokenizerClass=T5TokenizerFast",
            f"model_config.TokenizerModelVersion={FIXTURE}",
            f"model_config.model_args.sentinel_base={sentinel}",
            "model_config.ConfigClass=T5_test", "model_config.pretrained=0",
            "model_config.model_args.prefix_size=8",
            "model_config.model_args.prefix_length=2",
            "tpu.compute_dtype=float32", "tpu.params_dtype=float32"]
    config = config_system.parse_optional_args(
        config_system.get_config_from_file(config_file), opts)
    config.mode = "test"
    model, _ = model_factory.build_model_from_config(config, device="cpu")
    checkpointing.save_checkpoint(str(tmp_path / "saved_model"), 0,
                                  {"mapper": model.params["mapper"]})
    rows = np.random.default_rng(0).standard_normal((5, 8)).astype(
        np.float32)
    with open(tmp_path / "e.pkl", "wb") as fh:
        pickle.dump({str(i): row[None] for i, row in enumerate(rows)}, fh)
    out = t_captions.main([
        config_file, "--checkpoint", str(tmp_path / "saved_model" / "model_00"),
        "--embeddings", str(tmp_path / "e.pkl"), "--out",
        str(tmp_path / "captions.txt"), "--limit", "4", "--device", "cpu",
        "--opts", *opts])
    want = t_captions.generate_captions(
        model, ttok.load_tokenizer("T5TokenizerFast", FIXTURE), rows[:4])
    assert out["captions"] == want and len(want) == 4
    assert all(c.startswith("A picture of") for c in want)
    assert (tmp_path / "captions.txt").read_text().split("\n") == want
    assert out["generate_s"] > 0.0


# --- replicate_baseline ---------------------------------------------------------

def harness_argv(tmp_path, *extra):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    names = ("questions_train", "annotations_train", "questions_val",
             "annotations_val", "clip_train", "clip_val", "rices",
             "text_rices", "random")
    files = {name: str(data / f"{name}.json") for name in names}
    for name in names[:-2]:
        open(files[name], "w").close()
    weights = tmp_path / "t0"
    weights.mkdir(exist_ok=True)
    (weights / "config.json").write_text("{}")
    return [
        "--t0-weights", str(weights),
        "--questions-train", files["questions_train"],
        "--annotations-train", files["annotations_train"],
        "--questions-val", files["questions_val"],
        "--annotations-val", files["annotations_val"],
        "--clip-embeddings-train", files["clip_train"],
        "--clip-embeddings-val", files["clip_val"],
        "--rices", files["rices"],
        "--text-rices", files["text_rices"],
        "--random-examples", files["random"],
        "--workdir", str(tmp_path / "work"), "--batch-size", "4",
        "--opts", "tpu.int8_encoder_ffn=True",
        "data_loader.additional.max_target_length=8", *extra]


LM = {"vocab_size": 256, "d_model": 32, "d_kv": 8, "num_heads": 4,
      "d_ff": 64, "num_encoder_layers": 2, "num_decoder_layers": 2,
      "relative_attention_num_buckets": 8,
      "relative_attention_max_distance": 16}


@pytest.mark.parametrize("mode,template,shots,strip", [
    ("main", "hotpotqa", 0, False), ("main", "frozen", 8, False),
    ("main", "hotpotqa", 2, True), ("no_prefix", "hotpotqa", 1, False),
    ("text_rices", "hotpotqa", 4, False), ("ensemble", "hotpotqa", 2, False),
    ("random", "hotpotqa", 8, False)])
def test_build_config_equals_jax(tmp_path, mode, template, shots, strip):
    """Every published-table mode's config field by field, the bf16 twin's
    (int8 overrides stripped) among them; only the run's own arguments
    (the port's --device) differ."""
    argv = harness_argv(tmp_path)
    os.chdir(REPO)
    configs = []
    for rb in (j_rb, t_rb):
        args = rb.parse_args(argv)
        config = rb._build_config(template, shots, args, dict(LM),
                                  str(tmp_path / "mapper"), 228, mode=mode,
                                  strip_int8=strip)
        configs.append(config.to_dict())
    want, got = configs
    assert set(got) == set(want)
    for key in want:
        if key == "args":
            continue
        assert got[key] == want[key], key
    assert {k: v for k, v in got["args"].items() if k != "device"} == \
        want["args"]
    assert got["tpu"].get("int8_encoder_ffn") is (None if strip else True)
    assert got["test"]["load_model_path"] == str(tmp_path / "mapper")


def test_build_config_user_opts_win(tmp_path):
    """The user's --opts are applied after the harness's own settings: a
    run without T0's tokenizer files picks SimpleTokenizer on the command
    line, and a batch size given there wins over --batch-size (JAX's
    harness sets its own over both). Every other field equals JAX's."""
    argv = harness_argv(tmp_path, "model_config.TokenizerClass=SimpleTokenizer",
                        "test.batch_size=2")
    os.chdir(REPO)
    want, got = (rb._build_config("hotpotqa", 2, rb.parse_args(argv),
                                  dict(LM), None, 228).to_dict()
                 for rb in (j_rb, t_rb))
    assert want["model_config"]["TokenizerClass"] == "T5TokenizerFast"
    assert want["test"]["batch_size"] == 4
    assert got["model_config"]["TokenizerClass"] == "SimpleTokenizer"
    assert got["test"]["batch_size"] == 2
    got["model_config"]["TokenizerClass"] = "T5TokenizerFast"
    got["test"]["batch_size"] = 4
    for key in set(want) - {"args"}:
        assert got[key] == want[key], key


def test_check_artifacts_lists_what_jax_lists(tmp_path):
    """The missing-artifact checklist: the same entries, in order."""
    argv = harness_argv(tmp_path, "--modes", "main", "random", "text_rices",
                        "--mapper-ckpt", str(tmp_path / "missing.ckpt"))
    want = j_rb.check_artifacts(j_rb.parse_args(argv))
    got = t_rb.check_artifacts(t_rb.parse_args(argv))
    assert got == want
    assert len(got) == 3 and got[0].startswith("--mapper-ckpt")


def test_orbax_directory_is_refused(tmp_path):
    """A mapper directory without the port's state file names the Orbax
    converter; a port checkpoint directory is used as it is."""
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="convert_orbax_checkpoint"):
        t_rb._resolve_mapper_ckpt(str(tmp_path / "orbax"), "mlp",
                                  str(tmp_path))
    port = tmp_path / "model_00"
    port.mkdir()
    (port / "trainable_state.pt").write_bytes(b"")
    assert t_rb._resolve_mapper_ckpt(str(port), "mlp", str(tmp_path)) == \
        str(port)


def test_print_report_prints_what_jax_prints(capsys):
    rows = [
        {"mode": "main", "template": "hotpotqa", "num_shots": 0,
         "accuracy": 33.1, "reference": 34.49, "delta": -1.39,
         "verdict": "FAIL", "questions": 4, "questions_per_s": 12.5,
         "wall_s": 0.3},
        {"mode": "main", "template": "hotpotqa", "num_shots": 2,
         "accuracy": 39.5, "reference": 39.66, "delta": -0.16,
         "verdict": "PASS", "questions": 4, "questions_per_s": 10.0,
         "wall_s": 0.4, "accuracy_bf16": 39.7,
         "bf16_questions_per_s": 9.0, "int8_vs_bf16_delta": -0.2,
         "int8_verdict": "PASS"},
        {"mode": "random", "template": "hotpotqa", "num_shots": 1,
         "accuracy": None, "reference": None, "delta": None,
         "verdict": "n/a", "questions": 4, "questions_per_s": 1.0,
         "wall_s": 4.0},
    ]
    outputs = []
    for rb in (j_rb, t_rb):
        for random_mapper in (True, False):
            rb.print_report({"rows": rows, "random_mapper": random_mapper,
                             "all_pass": False, "tolerance": 0.3})
            outputs.append(capsys.readouterr().out)
    assert outputs[2:] == outputs[:2]
    assert "int8Δ -0.20" in outputs[2]


def test_published_tables_equal_jax():
    assert t_rb.BASELINE_NUMBERS == j_rb.BASELINE_NUMBERS
    assert t_rb.MODE_BASELINES == j_rb.MODE_BASELINES
    assert t_rb.MODE_DEFAULT_SHOTS == j_rb.MODE_DEFAULT_SHOTS
    assert t_rb.TEMPLATE_CONFIGS == j_rb.TEMPLATE_CONFIGS


# --- analysis tools -------------------------------------------------------------

def test_answer_length_analysis_equals_jax(tmp_path):
    preds = tmp_path / "answers.pkl"
    preds.write_bytes(pickle.dumps([
        {"question_id": 1, "answer": "red"},
        {"question_id": 2, "answer": "two dogs"},
        {"question_id": 3, "answer": "Blue "},
        {"question_id": 4, "answer": "a very long answer"},
    ]))
    examples = tmp_path / "rices.pkl"
    examples.write_bytes(pickle.dumps({
        "1": [{"gold_answer": "green"}, {"gold_answer": "red"}],
        "2": [{"gold_answer": "blue"}],
        "3": [{"gold_answer": "blue"}, {"gold_answer": "no"}],
    }))
    for shots in (0, 1, 2):
        want = j_answers.analyse(str(preds), str(examples), num_shots=shots)
        got = t_answers.analyse(str(preds), str(examples), num_shots=shots)
        assert got == want
    assert got["num_predictions"] == 4 and got["copy_from_shot_rate"] == (
        2 / 3)


def test_report_plots_equal_jax(tmp_path):
    """collect_results' curves equal JAX's; both PNGs written."""
    for i, (method, shots, acc) in enumerate([
            ("ours", 0, 30.5), ("ours", 4, 35.25), ("random", 1, 24.0)]):
        folder = tmp_path / "results" / f"run{i}"
        folder.mkdir(parents=True)
        (folder / "metrics.json").write_text(json.dumps(
            {"num_shots": shots, "method": method, "accuracy_overall": acc}))
    (tmp_path / "results" / "run0" / "other.json").write_text("{}")
    dirs = [str(tmp_path / "results")]
    want = j_plots.collect_results(dirs)
    got = t_plots.collect_results(dirs)
    assert got == want == {"ours": {0: 30.5, 4: 35.25}, "random": {1: 24.0}}
    for plots, name in ((j_plots, "jax.png"), (t_plots, "port.png")):
        out = plots.plot_curves(got, str(tmp_path / name))
        with open(out, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_visualise_opens_the_images_jax_opens(tmp_path, monkeypatch):
    """The grid's image paths, in order, equal JAX's; both PNGs written."""
    from PIL import Image

    train, val = tmp_path / "train", tmp_path / "val"
    train.mkdir()
    val.mkdir()
    for i in range(6):
        Image.new("RGB", (8, 8), (40 * i, 0, 0)).save(
            train / f"COCO_train2014_{str(i).zfill(12)}.jpg")
    Image.new("RGB", (8, 8)).save(val / f"COCO_val2014_{'7'.zfill(12)}.jpg")
    examples = tmp_path / "rices.pkl"
    examples.write_bytes(pickle.dumps({"42": [
        {"img_key": i, "question": f"q{i}?", "gold_answer": f"a{i}"}
        for i in range(6)]}))
    opened = []
    open_image = Image.open

    def recording(path, *args, **kwargs):
        opened.append(str(path))
        return open_image(path, *args, **kwargs)

    monkeypatch.setattr(Image, "open", recording)
    lists = []
    for vis, name in ((j_vis, "jax.png"), (t_vis, "port.png")):
        opened.clear()
        out = vis.visualise("42", str(examples), str(train), str(val), 7,
                            str(tmp_path / name), num_shots=3)
        assert os.path.getsize(out) > 0
        lists.append(list(opened))
    assert lists[1] == lists[0]
    assert [os.path.basename(p) for p in lists[1]] == [
        f"COCO_train2014_{str(i).zfill(12)}.jpg" for i in (3, 4, 5)] + [
        f"COCO_val2014_{'7'.zfill(12)}.jpg"]


def test_collect_env_info_keys():
    info = device_stats.collect_env_info()
    for key in ("python", "platform", "torch", "cuda", "cuda_available",
                "device_count", "numpy"):
        assert key in info and isinstance(info[key], str), key
    assert info["cuda_available"] == str(torch.cuda.is_available())
    if not torch.cuda.is_available():
        assert info["device_count"] == "0" and "device_kind" not in info
    device_stats.print_device_statistics()
