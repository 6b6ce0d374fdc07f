"""The port's config path against the JAX package's, in one process: the
jsonnet evaluator on the committed corpus, ``process_config`` on every
shipped config, ``--opts`` overrides, ``AttrDict``, ``Registry``, the CLI
parser and the seeding."""

import glob
import json
import logging
import os
import random
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu import main as jmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu import registry as jregistry  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import attr_dict as jattr  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import config_system as jconfig  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import jsonnet_eval as jjsonnet  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import seed as jseed  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch import registry as tregistry  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import attr_dict as tattr  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import config_system as tconfig  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import jsonnet_eval as tjsonnet  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import seed as tseed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures", "jsonnet_corpus")
EXT_VARS = {"env": "prod"}  # consumed by the corpus's extvar cases
GOLDEN_CASES = sorted(
    p for p in glob.glob(os.path.join(CORPUS, "*.jsonnet"))
    if not os.path.basename(p).startswith("err_"))
ERROR_CASES = sorted(glob.glob(os.path.join(CORPUS, "err_*.jsonnet")))
SHIPPED_CONFIGS = [
    "configs/vqa2/base_env.jsonnet",
    "configs/vqa2/few_shot_vqa_hotpotqa.jsonnet",
    "configs/vqa2/few_shot_vqa_frozen.jsonnet",
    "configs/vqa2/clip_cap.jsonnet",
    "configs/conceptual_captions/base_env.jsonnet",
    "configs/conceptual_captions/base_env_debug.jsonnet",
    "configs/conceptual_captions/conceptual_captions.jsonnet",
    "configs/conceptual_captions/conceptual_captions_debug.jsonnet",
]


def as_json(value):
    return json.loads(json.dumps(value))


def test_corpus_has_its_41_cases():
    assert (len(GOLDEN_CASES), len(ERROR_CASES)) == (24, 17)


@pytest.mark.parametrize("path", GOLDEN_CASES, ids=os.path.basename)
def test_jsonnet_golden_case_matches_jax(path):
    with open(path.replace(".jsonnet", ".golden.json"), encoding="utf-8") as fh:
        want = json.load(fh)
    got = as_json(tjsonnet.evaluate_file(path, ext_vars=EXT_VARS))
    assert got == want
    assert got == as_json(jjsonnet.evaluate_file(path, ext_vars=EXT_VARS))


@pytest.mark.parametrize("path", ERROR_CASES, ids=os.path.basename)
def test_jsonnet_error_case_raises_as_jax_does(path):
    with pytest.raises(jjsonnet.JsonnetError) as jexc:
        jjsonnet.evaluate_file(path, ext_vars=EXT_VARS)
    with pytest.raises(tjsonnet.JsonnetError) as texc:
        tjsonnet.evaluate_file(path, ext_vars=EXT_VARS)
    assert str(texc.value) == str(jexc.value)


def cli(rel, *extra):
    return [os.path.join(REPO, rel), "--mode", "test", *extra]


@pytest.mark.parametrize("rel", SHIPPED_CONFIGS)
def test_process_config_matches_golden_and_jax(rel):
    golden = os.path.join(
        REPO, "tests", "fixtures", "config_goldens",
        rel.replace("configs/", "").replace("/", "__").replace(
            ".jsonnet", ".json"))
    with open(golden, encoding="utf-8") as fh:
        want = json.load(fh)
    path = os.path.join(REPO, rel)
    assert as_json(tconfig.get_config_from_file(path)) == want
    argv = cli(rel, "--num_shots", "4", "--opts", "test.batch_size=16")
    got = tconfig.process_config(tmain.parse_args_sys(argv))
    ref = jconfig.process_config(jmain.parse_args_sys(argv))
    assert isinstance(got, tattr.AttrDict)
    assert as_json(got.to_dict()) == as_json(ref.to_dict())
    # the same default folders beside the same repository root
    assert got.EXPERIMENT_FOLDER == ref.EXPERIMENT_FOLDER


def test_opts_override_at_any_depth_as_jax_does():
    opts = ["a.b.c.d.e.f.g.h=[1, {'x': (2, 3)}]",
            "model_config.lm_config.fused_decode_attention=True",
            "tpu.compute_dtype=float32", "seed=7", "a.b.c.d.e.f.g.i=1e-3",
            "test.evaluation_name=x=y", "model_config.pretrained=None"]
    argv = cli("configs/vqa2/few_shot_vqa_hotpotqa.jsonnet", "--opts", *opts)
    got = tconfig.process_config(tmain.parse_args_sys(argv))
    ref = jconfig.process_config(jmain.parse_args_sys(argv))
    assert as_json(got.to_dict()) == as_json(ref.to_dict())
    assert got.a.b.c.d.e.f.g.h[1].x == (2, 3)
    assert got.model_config.lm_config.fused_decode_attention is True
    assert got.tpu.compute_dtype == "float32" and got.seed == 7
    assert got.test.evaluation_name == "x=y"
    with pytest.raises(ValueError, match="key=value"):
        tconfig.parse_optional_args(tattr.AttrDict(), ["no_equals"])


def test_opts_never_eval_code():
    config = tconfig.parse_optional_args(
        tattr.AttrDict(), ["x=__import__('os').getcwd()"])
    assert config.x == "__import__('os').getcwd()"


def test_save_config_writes_what_jax_writes(tmp_path):
    argv = cli("configs/vqa2/few_shot_vqa_hotpotqa.jsonnet")
    tconfig.save_config(tconfig.process_config(tmain.parse_args_sys(argv)),
                        str(tmp_path / "port" / "config.json"))
    jconfig.save_config(jconfig.process_config(jmain.parse_args_sys(argv)),
                        str(tmp_path / "jax" / "config.json"))
    assert ((tmp_path / "port" / "config.json").read_text()
            == (tmp_path / "jax" / "config.json").read_text())


def test_attr_dict_matches_jax():
    src = {"train": {"batch_size": 32, "steps": [{"lr": 1e-4}, 3]},
           "t": ({"a": 1},)}
    for cls in (tattr.AttrDict, jattr.AttrDict):
        c = cls(src, extra={"k": 1})
        c.train.lr = 2e-4
        c.setdefault("new", {"x": 1}).y = 2
        c.update({"u": {"v": 1}}, w=[{"z": 0}])
        assert c.train.steps[0].lr == 1e-4 and c.t[0].a == 1
        assert isinstance(c.copy(), cls) and hasattr(c, "train")
        assert not hasattr(c, "missing")
        del c.extra
        with pytest.raises(AttributeError):
            del c.extra
    t, j = (cls(src, extra={"k": 1}) for cls in (tattr.AttrDict,
                                                  jattr.AttrDict))
    assert t.to_dict() == j.to_dict() and t == j


def test_registry_matches_jax():
    for mod in (tregistry, jregistry):
        reg = mod.Registry("thing")

        @reg.register()
        def first():
            return 1

        reg.register("second")(first)
        with pytest.raises(KeyError, match="duplicate thing"):
            reg.register("second")(lambda: 2)
        assert "first" in reg and reg.get("second") is first
        assert reg.names() == ["first", "second"]
        with pytest.raises(KeyError, match="registered: first, second"):
            reg.get("third")
    for name in ("DATA_LOADERS", "DATASETS", "EXECUTORS", "MODELS",
                 "METRICS"):
        assert getattr(tregistry, name).kind == getattr(jregistry, name).kind
    # the port's models register under the config's ModelClass names
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0  # noqa: F401
    assert {"VCT0Model", "VCT0Prefix"} <= set(tregistry.MODELS.names())


@pytest.mark.parametrize("extra", [
    [],
    ["--mode", "train", "--num_shots", "2", "--no_prefix", "1",
     "--tags", "a", "b", "--modules", "m", "--disable_wandb",
     "--test_batch_size", "8", "--opts", "a.b=1", "c=d"],
])
def test_parse_args_sys_matches_jax(extra):
    argv = ["configs/vqa2/few_shot_vqa_hotpotqa.jsonnet", *extra]
    assert vars(tmain.parse_args_sys(argv)) == vars(jmain.parse_args_sys(argv))


def test_main_names_the_unported_steps(tmp_path, monkeypatch):
    """main.run runs the eval now (tests/test_torch_eval_cli.py), and
    training and eval over several processes on a (data, model) mesh
    (tests/test_torch_dp_train.py, tests/test_torch_multiprocess_eval.py);
    what it still refuses before any process group or data names its
    ROADMAP item: the pipelined mesh (tpu.mesh.pipe > 1) over more than one
    process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
            tmain.run(["configs/vqa2/few_shot_vqa_hotpotqa.jsonnet",
                       "--mode", "train", "--opts", "tpu.mesh.pipe=2",
                       f"EXPERIMENT_FOLDER={tmp_path}/experiments",
                       f"TENSORBOARD_FOLDER={tmp_path}/tb"])
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


def test_set_seed_seeds_the_host_as_jax_does():
    jseed.set_seed(11)
    want = (random.random(), np.random.rand())
    gen = tseed.set_seed(11)
    assert (random.random(), np.random.rand()) == want
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 11
    assert torch.equal(torch.rand(3), torch.rand(
        3, generator=torch.Generator().manual_seed(11)))
