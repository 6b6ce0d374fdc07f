"""The port's eval over two processes on the CPU (a gloo group, each rank
its [r::2] question shard; ``tools/multiprocess_eval.py`` starts them as a
launcher would): the gathered predictions against the one-process run's,
question by question, and rank 0's accuracy against its accuracy; the
shards against JAX's ``BatchIterator(shard_id=r, num_shards=2)``; the int8
calibration statistics max-reduced across the ranks; rank 0 alone writing;
the pipelined mesh over two processes refused, naming ROADMAP Queue 1
item 14 (the pipeline; training on the (data, model) mesh is
tests/test_torch_dp_train.py's). The
fixture tokenizer gives every word one id whatever a shard holds, so the
two runs' prompts are the same tokens. Answers and statistics are compared
exactly: the same fp32 arithmetic on the same rows."""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu.data.loader import (  # noqa: E402
    BatchIterator as JBatchIterator,
)
from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (  # noqa: E402
    MapperConfig,
    init_mapper,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import (  # noqa: E402
    gather_predictions_to_host0,
    max_across_processes,
    metric_psum,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    multiprocess_eval,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    checkpointing as tckpt,
)
from test_e2e import (  # noqa: E402
    PREFIX_SIZE,
    make_test_config,
    use_fixture_tokenizer,
    write_vqa_fixtures,
)
from test_torch_eval_cli import argv, cli_env  # noqa: E402,F401
from test_torch_eval_data import loaders  # noqa: E402

N_VAL = 7            # shards of 4 and 3 questions; rank 1 pads its last batch
TIMEOUT = 120.0      # seconds a two-process run may take
ACCURACY = "test_evaluation/accuracy_overall"
INT8_OPTS = ("tpu.fused_attention=true", "tpu.int8_encoder_ffn=true",
             "tpu.int8_encoder_attn=true", "tpu.int8_calibrate_batches=1")


def fixture_opts(tmp_path, fixtures):
    config = use_fixture_tokenizer(make_test_config(tmp_path, fixtures))
    return ["model_config.TokenizerClass=T5TokenizerFast",
            "model_config.TokenizerModelVersion="
            f"{config.model_config.TokenizerModelVersion}",
            "model_config.model_args.sentinel_base="
            f"{config.model_config.model_args.sentinel_base}"]


@pytest.fixture
def eval_argv(tmp_path, cli_env):  # noqa: F811
    """The CLI's test run on the fixtures with the fixture tokenizer and a
    saved random mapper named by test.load_model_path."""
    fixtures = write_vqa_fixtures(tmp_path, n_val_imgs=N_VAL)
    mapper = init_mapper(torch.Generator().manual_seed(0), MapperConfig(
        prefix_size=PREFIX_SIZE, d_model=32, prefix_length=2,
        clip_length=2))
    ckpt = tckpt.save_checkpoint(str(tmp_path / "ckpt"), 0,
                                 {"mapper": mapper})

    def make(folder, *opts, mode="test"):
        return argv(tmp_path, fixtures, folder,
                    *fixture_opts(tmp_path, fixtures),
                    f"test.load_model_path={ckpt}", *opts, mode=mode)
    return make


def qids(predictions):
    return [p["question_id"] for p in predictions]


def test_two_process_eval_equals_one_process(tmp_path, eval_argv, cli_env):  # noqa: F811
    _, metrics = tmain.run(eval_argv("one"), device="cpu")
    with open(f"{tmp_path}/one/cli_test/test/test_evaluation/answers.pkl",
              "rb") as fh:
        want = {p["question_id"]: p["answer"] for p in pickle.load(fh)}
    ranks = multiprocess_eval.launch(eval_argv("two"), 2, tmp_path / "mp",
                                     device="cpu", timeout=TIMEOUT)
    r0, r1 = ranks
    # rank 0's answers.pkl holds the gathered list in JAX's order: rank 0's
    # shard, then rank 1's
    gathered = r0["predictions"]
    assert r1["predictions"] is None
    assert qids(gathered) == r0["shard"] + r1["shard"]
    assert sorted(qids(gathered)) == sorted(want)
    assert {p["question_id"]: p["answer"] for p in gathered} == want
    assert r0["metrics"][ACCURACY] == metrics[ACCURACY]
    # each shard is JAX's BatchIterator shard, in order
    (tmp_path / "jax_shards").mkdir()
    jdl, _ = loaders(tmp_path / "jax_shards", "fixture", 2)
    for rec in ranks:
        shard = JBatchIterator(jdl.test_dataset, batch_size=2,
                               collate_fn=jdl.test_dataset.collate_fn,
                               shard_id=rec["rank"], num_shards=2)
        want_ids = [q for batch in shard for q, ok in zip(
            batch.question_ids, batch.sample_valid) if ok]
        assert rec["shard"] == want_ids
        assert rec["batches"] == len(shard) == 2
        # CPU tensors: every wrapper took its plain version
        assert sorted(rec["launches"]) == sorted(
            multiprocess_eval.kernel_wrappers())
        assert not any(rec["launches"].values())
    assert len(r0["shard"]) == 4 and len(r1["shard"]) == 3
    # rank 0 alone writes the predictions
    answers = "cli_test/test/test_evaluation/answers.pkl"
    assert answers in r0["files"] and answers not in r1["files"]


def test_first_outputs_keep_the_first_encode_and_decode_step():
    """``FirstOutputs`` keeps the first call's output of ``t5_encode`` and
    of ``t5_decode_step`` (the logits) as fp32 arrays, ignores later calls,
    and puts the functions back after the run."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5
    from explicit_alignment_for_vqa_tasks_tpu_torch.ops import decoding

    cfg = tt5.T5Config.small_test()
    params = tt5.init_t5_params(torch.Generator().manual_seed(0), cfg,
                                torch.bfloat16)
    ids = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 1
    mask = torch.ones(2, 3, dtype=torch.int32)
    fns = (tt5.t5_encode, tt5.t5_decode_step)
    with multiprocess_eval.FirstOutputs() as first:
        hidden = tt5.t5_encode(params, cfg, input_ids=ids)
        tt5.t5_encode(params, cfg, input_ids=ids + 1)
        _, logprobs = decoding.greedy_decode_t5(params, cfg, hidden, mask,
                                                max_new_tokens=3)
    assert (tt5.t5_encode, tt5.t5_decode_step) == fns
    assert sorted(first.outputs) == sorted(multiprocess_eval.FirstOutputs.NAMES)
    got = first.outputs["t5_encode"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, hidden.float().numpy())
    logits = first.outputs["t5_decode_step"]
    assert logits.shape == (2, cfg.vocab_size)
    # the first step's log-probabilities are those of the kept logits
    want = torch.log_softmax(torch.from_numpy(logits), -1).max(-1).values
    np.testing.assert_allclose(logprobs[:, 0].numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_two_process_int8_calibration_max_reduces(tmp_path, eval_argv):
    ranks = multiprocess_eval.launch(eval_argv("int8", *INT8_OPTS), 2,
                                     tmp_path / "mp", device="cpu",
                                     timeout=TIMEOUT)
    r0, r1 = ranks
    assert sorted(r0["stats"]) == sorted(r1["stats"]) and r0["stats"]
    for key, value in r0["stats"].items():
        np.testing.assert_array_equal(r1["stats"][key], value)
        np.testing.assert_array_equal(value, np.maximum(
            r0["stats_local"][key], r1["stats_local"][key]))
        assert not np.array_equal(r0["stats_local"][key],
                                  r1["stats_local"][key])
    assert sorted(qids(r0["predictions"])) == [2000000 + i
                                               for i in range(N_VAL)]


def test_two_process_training_names_item_14(tmp_path, eval_argv):
    """Two processes train on the (data, model) mesh now; what they refuse
    is the pipelined mesh, tpu.mesh.pipe > 1, naming the pipeline's item."""
    ranks = multiprocess_eval.launch(
        eval_argv("train", "tpu.mesh.pipe=2", mode="train"), 2,
        tmp_path / "mp", device="cpu", timeout=TIMEOUT)
    for rec in ranks:
        assert "Queue 1 item 14" in rec["error"], rec["error"]
        assert "the pipeline" in rec["error"], rec["error"]
        assert rec["metrics"] is None


def test_one_process_exchanges_are_the_identity():
    preds = [{"question_id": 1, "answer": "red"}]
    assert gather_predictions_to_host0(preds) is preds
    value = torch.tensor([1.0, 3.0])
    assert max_across_processes(value) is value
    assert metric_psum(torch.tensor(2.5)).item() == 2.5


def _exchange_worker(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        gathered = gather_predictions_to_host0(
            [f"r{rank}q{i}" for i in range(rank + 1)])
        reduced = max_across_processes(
            torch.tensor([float(rank), 5.0 - rank, -1.0]))
        total = metric_psum(torch.tensor(float(rank + 1)))
        with open(os.path.join(out, f"{rank}.pkl"), "wb") as fh:
            pickle.dump((gathered, reduced.tolist(), total.item()), fh)
    finally:
        dist.destroy_process_group()


def test_exchanges_over_two_processes(tmp_path):
    """The gather keeps rank order (lists of unequal lengths); the max and
    the sum reduce element-wise, the same on both ranks."""
    ctx = mp.get_context("spawn")
    port = multiprocess_eval.free_port()
    procs = [ctx.Process(target=_exchange_worker,
                         args=(r, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    assert all(p.exitcode == 0 for p in procs)
    for rank in range(2):
        with open(tmp_path / f"{rank}.pkl", "rb") as fh:
            gathered, reduced, total = pickle.load(fh)
        assert gathered == ["r0q0", "r1q0", "r1q1"]
        assert reduced == [1.0, 5.0, -1.0]
        assert total == 3.0


def test_checkpoint_written_by_rank_0_alone(tmp_path, monkeypatch):
    state = {"mapper": {"w": torch.ones(2)}}
    monkeypatch.setenv("RANK", "1")
    path = tckpt.save_checkpoint(str(tmp_path / "r1"), 0, state)
    assert path.endswith("model_00") and not (tmp_path / "r1").exists()
    monkeypatch.setenv("RANK", "0")
    tckpt.save_checkpoint(str(tmp_path / "r0"), 0, state)
    assert (tmp_path / "r0" / "checkpoint_index.json").is_file()
    assert (tmp_path / "r0" / "model_00" / tckpt.STATE_FILE).is_file()
