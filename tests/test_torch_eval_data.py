"""The port's data side (data/: the VQA2 loader and dataset, ModuleParser,
prompt templates, tokenizers, BatchIterator) against the JAX package's, in
one process on the CPU: the same synthetic VQA2 files give field-by-field
equal batches at 2 and 4 shots, for SimpleTokenizer and the committed
subword fixture; the seeded template and example draws are the JAX
package's; BatchIterator keeps order, shards and the partial batch, and
its threaded output equals a serial loop."""

import copy
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu.data import loader as jloader  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.data import in_context_examples as jice  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.data import tokenization as jtok  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.data import module_parser as jmp  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.registry import DATA_LOADERS as JDL  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils import seed as jseed  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.data import in_context_examples as tice  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.data import loader as tloader  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.data import module_parser as tmp_  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.data import tokenization as ttok  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.registry import DATA_LOADERS as TDL  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import seed as tseed  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import AttrDict as TAttrDict  # noqa: E402
from test_e2e import (  # noqa: E402
    make_test_config,
    use_fixture_tokenizer,
    write_vqa_fixtures,
)


def port_config(jconfig, tmp_path):
    """The JAX test config as the port's AttrDict, with its own cache and
    result folders so that neither package reads the other's pickles."""
    config = TAttrDict(copy.deepcopy(jconfig.to_dict()))
    config.cache.default_folder = str(tmp_path / "torch_cache")
    config.results_path = str(tmp_path / "torch_results")
    config.saved_model_path = str(tmp_path / "torch_saved_model")
    return config


def loaders(tmp_path, tokenizer, num_shots, **additional):
    fixtures = write_vqa_fixtures(tmp_path, n_train_imgs=6, n_val_imgs=7)
    jconfig = make_test_config(tmp_path, fixtures, **additional)
    jconfig.data_loader.additional.num_shots = num_shots
    if tokenizer == "fixture":
        jconfig = use_fixture_tokenizer(jconfig)
    tconfig = port_config(jconfig, tmp_path)
    if tokenizer != "fixture":
        # SimpleTokenizer gives ids in first-seen order: the JAX package
        # keeps that order the dataset's with one collate thread, and the
        # port picks one thread itself from the default of 4
        jconfig.data_loader.additional.num_workers_test = 1
    out = []
    for registry, config in ((JDL, jconfig), (TDL, tconfig)):
        data_loader = registry.get(config.data_loader.type)(config)
        data_loader.build_dataset()
        data_loader.set_dataloader()
        out.append(data_loader)
    return out


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("num_shots", [2, 4])
@pytest.mark.parametrize("tokenizer", ["simple", "fixture"])
def test_vqa2_batches_equal_jax(tmp_path, tokenizer, num_shots):
    jdl, tdl = loaders(tmp_path, tokenizer, num_shots)
    assert len(tdl.test_dataloader) == len(jdl.test_dataloader) == 4
    assert sorted(tdl.data.vqa_data.lookup) == sorted(jdl.data.vqa_data.lookup)
    assert (tdl.data.vqa_data.answer_candidate_list
            == jdl.data.vqa_data.answer_candidate_list)
    jbatches, tbatches = list(jdl.test_dataloader), list(tdl.test_dataloader)
    assert len(tbatches) == len(jbatches)
    for got, want in zip(tbatches, jbatches):
        assert_batches_equal(got, want)
        assert got.clip_embeddings.shape == (2, num_shots + 1, 16)
        # every prompt holds its num_shots + 1 sentinels
        sentinel = tdl.tokenizer.convert_tokens_to_ids("<extra_id_0>")
        assert ((got.generative_input_ids == sentinel).sum(1) == 1).all()
    # the last batch is padded with its last question and marked so
    assert tbatches[-1].sample_valid.tolist() == [True, False]
    assert tbatches[-1].question_ids[1] == tbatches[-1].question_ids[0]


@pytest.mark.parametrize("tokenizer,threads", [("simple", 1),
                                               ("fixture", 4)])
def test_collate_threads_follow_the_tokenizer(tmp_path, tokenizer, threads):
    """SimpleTokenizer collates on one thread, whatever num_workers_test
    says, so that two runs number the words alike; a fixed vocabulary
    keeps the configured pool."""
    jdl, tdl = loaders(tmp_path, tokenizer, 2)
    assert tdl.config.data_loader.additional.get("num_workers_test", 4) == 4
    assert tdl.test_dataloader.num_workers == threads
    if tokenizer == "simple":
        (tmp_path / "again").mkdir()
        _, again = loaders(tmp_path / "again", tokenizer, 2)
        for got, want in zip(again.test_dataloader, jdl.test_dataloader):
            assert_batches_equal(got, want)


def test_vqa2_batches_equal_jax_when_cached(tmp_path):
    """A second loader on the same cache folders reads the pickled splits
    and embeddings back: the same batches."""
    jdl, tdl = loaders(tmp_path, "fixture", 2)
    _, again = loaders(tmp_path, "fixture", 2)
    for got, want in zip(again.test_dataloader, jdl.test_dataloader):
        assert_batches_equal(got, want)
    assert again.data.clip_embeddings.keys() == tdl.data.clip_embeddings.keys()


def test_sampled_templates_and_random_examples_draw_as_jax():
    """The global random / np.random streams, seeded by each package's
    set_seed, draw the same templates and the same random examples."""
    examples = [{"question": f"q{i}", "gold_answer": f"a{i}",
                 "question_id": i, "img_key": 100 + i} for i in range(9)]
    test = {"question": "what is it ?"}
    got, want = [], []
    for mod, seed_mod, out in ((tice, tseed, got), (jice, jseed, want)):
        seed_mod.set_seed(5)
        fmt = mod.InContextExampleFormatter("hotpotqa", sample_templates=True)
        selector = mod.InContextExampleSelector(3, list(range(9)), examples)
        for _ in range(6):
            out.append(fmt.format_input(selector.get_random_examples(), test))
    assert got == want
    assert len(set(got)) > 1
    assert tice.FORMATS == jice.FORMATS


@pytest.mark.parametrize("length,buckets,cap", [
    (5, [8, 16], 16), (9, [8, 16], 16), (20, [8, 16], 16), (7, None, 12),
    (3, [16, 4, 8], 12)])
def test_bucketing_equals_jax(length, buckets, cap):
    assert (tmp_.pick_bucket(length, buckets, cap)
            == jmp.pick_bucket(length, buckets, cap))
    arr = np.arange(2 * length).reshape(2, length)
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            tmp_.pad_to_length(arr, cap, -1, side),
            jmp.pad_to_length(arr, cap, -1, side))


def test_simple_tokenizer_equals_jax():
    texts = ["<extra_id_0>\nCombine facts and answer this:\nwhat is it ?\n",
             "a b <extra_id_3> c</s> <pad>", "zzz yyy xxx a b"]
    tt, jt = ttok.SimpleTokenizer(), jtok.SimpleTokenizer()
    assert ttok.T5_SENTINEL_BASE == jtok.T5_SENTINEL_BASE == 32099
    for kwargs in ({}, {"padding_side": "left"},
                   {"max_length": 4, "truncation": True}):
        got, want = tt(texts, **kwargs), jt(texts, **kwargs)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], want[key])
    ids = tt(texts)["input_ids"]
    assert [tt.decode(r) for r in ids] == [jt.decode(r) for r in ids]
    assert (tt.convert_tokens_to_ids(["<extra_id_2>", "b"])
            == jt.convert_tokens_to_ids(["<extra_id_2>", "b"]))


def test_simple_tokenizer_interns_each_word_once_across_threads():
    """Collate threads intern words at once: every word gets exactly one
    id, and the ids are the consecutive range the words took."""
    import sys
    import threading

    tok = ttok.SimpleTokenizer()
    words = [f"w{i}" for i in range(400)]
    seen = [None] * 8

    def work(k):
        seen[k] = [tok.tokenize_to_ids(w)[0] for w in words]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(s == seen[0] for s in seen)
    assert sorted(seen[0]) == list(range(1000, 1400))


def collate(samples):
    return {"rows": np.asarray(samples), "text": [str(s) for s in samples]}


@pytest.mark.parametrize("n,batch,shards,workers", [
    (23, 5, 1, 4), (23, 5, 3, 4), (10, 4, 2, 1), (7, 8, 1, 2), (32, 8, 4, 0)])
def test_batch_iterator_equals_jax_and_a_serial_loop(n, batch, shards,
                                                     workers):
    def run(mod, shard, **kwargs):
        it = mod.BatchIterator(mod.ListDataset(list(range(n))), batch,
                               collate, shard_id=shard, num_shards=shards,
                               **kwargs)
        out = [(b["rows"].tolist(), b["text"], b["sample_valid"].tolist())
               for b in it]
        assert len(out) == len(it)
        return out

    union = []
    for shard in range(shards):
        threaded = run(tloader, shard, num_workers=workers)
        serial = run(tloader, shard, prefetch=0)
        assert threaded == serial == run(jloader, shard, num_workers=workers)
        want = list(range(n))[shard::shards]
        rows = [r for b in serial for r, v in zip(b[0], b[2]) if v]
        assert rows == want                  # in order, each once
        last_rows, _, last_valid = serial[-1]
        assert len(last_rows) == batch       # the partial batch is kept
        assert last_valid.count(True) == len(want) - batch * (len(serial) - 1)
        union += rows
    assert sorted(union) == list(range(n))


def test_batch_iterator_surfaces_collate_errors():
    def bad(samples):
        raise ValueError("boom")

    for workers in (0, 3):
        it = tloader.BatchIterator(tloader.ListDataset(list(range(9))), 2,
                                   bad, num_workers=workers)
        with pytest.raises(ValueError, match="boom"):
            list(it)


def test_world_size_refuses_more_than_one_process(tmp_path, monkeypatch):
    from explicit_alignment_for_vqa_tasks_tpu_torch.device import world_size

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert world_size() == 1
    jdl, tdl = loaders(tmp_path, "fixture", 2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        world_size()
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tdl.set_dataloader()


def test_module_parser_post_processors_equal_jax(tmp_path):
    """PostProcessOutputTokenization (labels with the first pad kept) and
    the default merge, on the fixture tokenizer."""
    jdl, tdl = loaders(tmp_path, "fixture", 2)
    random.seed(0)
    texts = ["red", "a blue one", "", "green green green"]
    got = tdl.test_dataset.PostProcessOutputTokenization(
        TAttrDict(text_sequence=list(texts)), None)
    want = jdl.test_dataset.PostProcessOutputTokenization(
        {"text_sequence": list(texts)}, None)
    assert_batches_equal(dict(got), dict(want))
    merged = tdl.test_dataset.DefaultProcessing(
        [{"a": "x", "b": 1}, {"a": "y"}])
    assert merged == {"a": "x y", "b": 1}
