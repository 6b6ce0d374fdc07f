"""The port's few-shot VQA eval in the paper's other modes and their
combinations against the JAX package's executor, on the CPU at the tiny
T5_test size (the fixture writers and weight carrying of
tests/test_torch_eval_e2e.py): permutations with beams, one-at-a-time
with beams, the ensembles with tpu.ensemble_members_per_call folding
members into one call (answers equal to the per-member loop's and to
JAX's), the int8 calibration under no_prefix, and its refusal for the
one-at-a-time and ensemble modes."""

import pytest

pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.checkpointing import (  # noqa: E402
    save_checkpoint,
)
from test_e2e import build_executor  # noqa: E402
from test_torch_eval_e2e import (  # noqa: E402
    answers,
    assert_same_eval,
    mode_configs,
    port_executor,
    run_both,
)

PERMUTATIONS = {"num_permutations_of_in_context_examples": 3}


@pytest.mark.parametrize("mode,additional,members_per_call,calls", [
    ("permutations_beams", {**PERMUTATIONS, "num_beams": 2}, 1, 3),
    ("one_at_a_time_beams",
     {"pass_examples_through_encoder_one_at_a_time": 1, "num_beams": 2}, 1,
     1),
    ("permutations_batched", PERMUTATIONS, 2, 2),
    ("permutations_one_call", PERMUTATIONS, 3, 1),
    ("one_shots_batched", {"ensemble_one_shots": 1}, 2, 1),
    ("permutations_beams_batched", {**PERMUTATIONS, "num_beams": 2}, 3, 1),
])
def test_mode_eval_equals_jax(tmp_path, mode, additional, members_per_call,
                              calls):
    jconfig, tconfig = mode_configs(tmp_path, mode, additional)
    for config in (jconfig, tconfig):
        config.tpu.ensemble_members_per_call = members_per_call
    jrun, trun = run_both(jconfig, tconfig)
    assert_same_eval(jrun, trun, jconfig, tconfig, 3, calls)


def test_batched_members_equal_the_loop(tmp_path):
    """members_per_call 1, 2 and 3 write the same answers.pkl."""
    got = []
    for m in (1, 2, 3):
        folder = tmp_path / f"m{m}"
        folder.mkdir()
        _, tconfig = mode_configs(folder, "permutations", PERMUTATIONS)
        tconfig.tpu.ensemble_members_per_call = m
        executor = port_executor(tconfig)
        # the config's seeded weights, the mapper through a checkpoint
        save_checkpoint(tconfig.saved_model_path, 0,
                        {"mapper": executor.model.params["mapper"]})
        executor.test()
        got.append(answers(tconfig))
    assert got[1] == got[0] and got[2] == got[0]


def test_int8_calibration_under_no_prefix_equals_jax(tmp_path):
    """The executor calibrates SmoothQuant on the text-only embeddings."""
    jconfig, tconfig = mode_configs(tmp_path, "no_prefix", {"no_prefix": 1})
    for config in (jconfig, tconfig):
        config.tpu.int8_encoder_ffn = True
        config.tpu.int8_encoder_attn = True
        config.tpu.fused_attention = True
        config.tpu.int8_calibrate_batches = 1
    jrun, trun = run_both(jconfig, tconfig)
    assert trun[0].model.pending_int8_calibration is None
    assert_same_eval(jrun, trun, jconfig, tconfig, 3)


@pytest.mark.parametrize("additional", [
    {"pass_examples_through_encoder_one_at_a_time": 1},
    {"ensemble_one_shots": 1}, PERMUTATIONS])
def test_int8_calibration_refuses_as_jax(tmp_path, additional):
    jconfig, tconfig = mode_configs(tmp_path, "refused", additional)
    for config in (jconfig, tconfig):
        config.tpu.int8_encoder_ffn = True
        config.tpu.int8_calibrate_batches = 1
    with pytest.raises(ValueError, match="int8_calibrate_batches") as want:
        build_executor(jconfig).test()
    with pytest.raises(ValueError, match="int8_calibrate_batches") as got:
        port_executor(tconfig).test()
    assert str(got.value) == str(want.value)
