"""The port's few-shot VQA eval end to end (trainers/: FewShotVQAExecutor
over BaseExecutor's eval loop, checkpoint loading, official scoring)
against the JAX package's executor, on the CPU at the tiny T5_test size of
tests/test_e2e.py: the JAX model's LM carried across by convert.py and its
mapper through the port's save_checkpoint, then equal generated tokens,
answers.pkl and metrics, for SimpleTokenizer and the committed subword
fixture and in the int8 calibrated eval; each other generate mode
(no_prefix, one-at-a-time, beams, a decoder prefix, the one-shot and
permutation ensembles) equal to JAX's the same way; the eval loop against
per-batch steps; and a missing checkpoint. (The VinVL, OCR, Oscar caption
and OK-VQA modules and OK-VQA scoring: tests/test_torch_okvqa.py.)"""

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


def configs(tmp_path, tokenizer="simple", n_val=5, **additional):
    fixtures = write_vqa_fixtures(tmp_path, n_val_imgs=n_val)
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


def assert_same_eval(jrun, trun, jconfig, tconfig, n_questions,
                     calls_per_batch=1):
    (_, jcalls, jmetrics), (_, tcalls, tmetrics) = jrun, trun
    assert len(tcalls) == len(jcalls) == -(-n_questions // 2) * \
        calls_per_batch
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


def mode_configs(tmp_path, mode, additional, n_val=3):
    """The test configs of one generate mode: its data_loader.additional
    flags, the no_prefix template, the decoder prefix's modules."""
    jconfig, tconfig = configs(tmp_path, n_val=n_val, **additional)
    for config in (jconfig, tconfig):
        if additional.get("no_prefix"):
            config.model_config.input_modules.module_list[0].option = (
                "hotpotqa_no_prefix")
        if mode.startswith("decoder_prefix"):
            config.model_config.decoder_input_modules = copy.deepcopy(
                DECODER_PREFIX)
    return jconfig, tconfig


@pytest.mark.parametrize("mode,additional,calls_per_batch", [
    ("ensemble_one_shots", {"ensemble_one_shots": 1}, 2),
    ("permutations", {"num_permutations_of_in_context_examples": 2}, 2),
    ("one_at_a_time", {"pass_examples_through_encoder_one_at_a_time": 1},
     1),
    ("no_prefix", {"no_prefix": 1}, 1),
    ("beams", {"num_beams": 2}, 1),
    ("decoder_prefix", {}, 1),
])
def test_generate_mode_eval_equals_jax(tmp_path, mode, additional,
                                       calls_per_batch):
    """The mode's generate calls (each ensemble member's too), answers.pkl
    and metrics equal the JAX executor's (tests/test_e2e.py:311-437)."""
    jconfig, tconfig = mode_configs(tmp_path, mode, additional)
    jrun, trun = run_both(jconfig, tconfig)
    assert_same_eval(jrun, trun, jconfig, tconfig, 3, calls_per_batch)
