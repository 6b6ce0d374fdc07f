"""The port's few-shot VQA eval end to end (trainers/: FewShotVQAExecutor
over BaseExecutor's eval loop, checkpoint loading, official scoring)
against the JAX package's executor, on the CPU at the tiny T5_test size of
tests/test_e2e.py: the JAX model's LM carried across by convert.py and its
mapper through the port's save_checkpoint, then equal generated tokens,
answers.pkl and metrics, for SimpleTokenizer and the committed subword
fixture and in the int8 calibrated eval; the eval loop against per-batch
steps; a missing checkpoint; and each generate mode, dataset module and
metric that is not ported yet raising with its ROADMAP item."""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.registry import (  # noqa: E402
    DATA_LOADERS as TDL,
    EXECUTORS as TEX,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.checkpointing import (  # noqa: E402
    save_checkpoint,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import AttrDict as TAttrDict  # noqa: E402
from test_e2e import (  # noqa: E402
    build_executor,
    make_test_config,
    use_fixture_tokenizer,
    write_vqa_fixtures,
)
from test_torch_eval_data import port_config  # noqa: E402


def configs(tmp_path, tokenizer="simple", **additional):
    fixtures = write_vqa_fixtures(tmp_path, n_val_imgs=5)
    jconfig = make_test_config(tmp_path, fixtures, **additional)
    if tokenizer == "fixture":
        jconfig = use_fixture_tokenizer(jconfig)
    else:
        # SimpleTokenizer gives ids in first-seen order: one collate
        # thread keeps that order, and so the ids, the same in both runs
        jconfig.data_loader.additional.num_workers_test = 1
    return jconfig, port_config(jconfig, tmp_path)


def port_executor(tconfig):
    data_loader = TDL.get(tconfig.data_loader.type)(tconfig)
    data_loader.build_dataset()
    data_loader.set_dataloader()
    return TEX.get(tconfig.train.type)(tconfig, data_loader, device="cpu")


def jax_params(jexecutor):
    """The JAX model's {"lm", "mapper"} as port tensors (fp32, the CPU)."""
    return vct0_params_from_numpy(
        jax.tree.map(np.asarray, jexecutor.model.params), torch.float32,
        "cpu")


def carry_weights(jexecutor, texecutor):
    """The JAX LM into the port model; the JAX mapper through a port
    checkpoint, loaded as a test run loads it."""
    params = jax_params(jexecutor)
    texecutor.model.params["lm"] = params["lm"]
    save_checkpoint(texecutor.config.saved_model_path, 0,
                    {"mapper": params["mapper"]})
    assert texecutor.maybe_load_checkpoint() is not None
    for key, leaf in texecutor.model.params["mapper"].items():
        torch.testing.assert_close(leaf, params["mapper"][key], rtol=0,
                                   atol=0)


def record_tokens(model):
    """Wrap the model's generate to keep each call's tokens as numpy."""
    calls = []
    generate = model.generate

    def recording(*args, **kwargs):
        tokens, logprobs = generate(*args, **kwargs)
        calls.append(np.asarray(tokens.cpu() if isinstance(
            tokens, torch.Tensor) else tokens))
        return tokens, logprobs

    model.generate = recording
    return calls


def answers(config):
    with open(os.path.join(config.results_path, "answers.pkl"), "rb") as fh:
        return pickle.load(fh)


def run_both(jconfig, tconfig):
    jexecutor = build_executor(jconfig)
    texecutor = port_executor(tconfig)
    carry_weights(jexecutor, texecutor)
    jcalls, tcalls = record_tokens(jexecutor.model), record_tokens(
        texecutor.model)
    jmetrics, tmetrics = jexecutor.test(), texecutor.test()
    return (jexecutor, jcalls, jmetrics), (texecutor, tcalls, tmetrics)


def assert_same_eval(jrun, trun, jconfig, tconfig, n_questions):
    (_, jcalls, jmetrics), (_, tcalls, tmetrics) = jrun, trun
    assert len(tcalls) == len(jcalls) == -(-n_questions // 2)
    for got, want in zip(tcalls, jcalls):
        # JAX pads a batch to its data axis; the extra rows repeat the last
        np.testing.assert_array_equal(got, want[:len(got)])
    assert "test_evaluation/accuracy_overall" in tmetrics
    assert tmetrics == jmetrics
    got, want = answers(tconfig), answers(jconfig)
    assert got == want
    assert sorted(p["question_id"] for p in got) == sorted(
        2000000 + i for i in range(n_questions))


@pytest.mark.parametrize("tokenizer", ["simple", "fixture"])
def test_eval_equals_jax(tmp_path, tokenizer):
    jconfig, tconfig = configs(tmp_path, tokenizer)
    jrun, trun = run_both(jconfig, tconfig)
    assert_same_eval(jrun, trun, jconfig, tconfig, 5)
    texecutor = trun[0]
    assert texecutor.model.device.type == "cpu"
    if tokenizer == "fixture":
        # the subword vocabulary decodes the tokens to words, not <unk>s
        assert any("<unk>" not in p["answer"] for p in answers(tconfig))


def test_int8_calibrated_eval_equals_jax(tmp_path):
    """tpu.int8_calibrate_batches defers the int8 quantization to the
    executor, which calibrates SmoothQuant on the first eval batch's
    spliced encoder inputs (JAX's test_int8_calibrated_eval)."""
    jconfig, tconfig = configs(tmp_path)
    for config in (jconfig, tconfig):
        config.tpu.int8_encoder_ffn = True
        config.tpu.int8_encoder_attn = True
        config.tpu.fused_attention = True
        config.tpu.int8_calibrate_batches = 1
    jrun, trun = run_both(jconfig, tconfig)
    texecutor = trun[0]
    assert texecutor.model.pending_int8_calibration is None
    encoder = texecutor.model.params["lm"]["encoder"]
    assert "ln" in encoder["ffn_q8"] and "ln" in encoder["self_attn_q8"]
    assert_same_eval(jrun, trun, jconfig, tconfig, 5)


def test_eval_loop_steps_each_batch_once_in_order(tmp_path):
    """BaseExecutor._eval_loop gives exactly the per-batch
    _generative_step outputs, in order, and stops at max_batches."""
    _, tconfig = configs(tmp_path)
    texecutor = port_executor(tconfig)
    stepwise = [texecutor._generative_step(batch, i)
                for i, batch in enumerate(texecutor.test_dataloader)]
    looped = texecutor._eval_loop()
    assert len(looped) == len(stepwise) == 3
    assert looped == stepwise
    assert texecutor._eval_loop(max_batches=2) == stepwise[:2]


@pytest.mark.parametrize("name", [
    "LoadVinVLFeatures", "LoadGoogleOCRFeatures", "LoadOscarCaptionFeatures",
    "LoadOKVQAData", "compute_okvqa_scores"])
def test_unported_dataset_modules_raise(tmp_path, name):
    """The modules that no shipped config's module_list names."""
    _, tconfig = configs(tmp_path)
    data_loader = TDL.get(tconfig.data_loader.type)(tconfig)
    if name.startswith("Load"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
            getattr(data_loader, name)(None)
        return
    data_loader.build_dataset()
    data_loader.set_dataloader()
    texecutor = TEX.get(tconfig.train.type)(tconfig, data_loader,
                                            device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        texecutor.compute_okvqa_scores(None, {}, TAttrDict())


def test_missing_checkpoint_raises(tmp_path):
    _, tconfig = configs(tmp_path)
    texecutor = port_executor(tconfig)
    with pytest.raises(FileNotFoundError, match="requires a checkpoint"):
        texecutor.maybe_load_checkpoint()


DECODER_PREFIX = TAttrDict(
    module_list=[{"type": "QuestionInput", "option": "default",
                  "separation_tokens": {"start": "", "end": ""}}],
    postprocess_module_list=[{"type": "PostProcessInputTokenization",
                              "option": "decoder_generation"}],
)


@pytest.mark.parametrize("mode,additional,item", [
    ("ensemble_one_shots", {"ensemble_one_shots": 1}, "item 9"),
    ("permutations", {"num_permutations_of_in_context_examples": 2},
     "item 9"),
    ("one_at_a_time", {"pass_examples_through_encoder_one_at_a_time": 1},
     "item 6"),
    ("no_prefix", {"no_prefix": 1}, "item 6"),
    ("beams", {"num_beams": 2}, "item 5"),
    ("decoder_prefix", {}, "item 6"),
])
def test_unported_generate_modes_raise(tmp_path, mode, additional, item):
    _, tconfig = configs(tmp_path, **additional)
    if mode == "no_prefix":
        tconfig.model_config.input_modules.module_list[0].option = (
            "hotpotqa_no_prefix")
    if mode == "decoder_prefix":
        tconfig.model_config.decoder_input_modules = copy.deepcopy(
            DECODER_PREFIX)
    texecutor = port_executor(tconfig)
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        texecutor.test()
