"""Conceptual Captions data loader (mapping-network training data).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/data/data_loader_conceptual_captions.py:
the pre-extracted CLIP-embedding parquet artifacts (columns image_url,
caption, clip_embeddings — reference:
src/data_loader_manager/data_loader_conceptual_captions.py:63-104) read
with pyarrow, caption batches collated with bucketed padding and pad ->
-100 labels. Where the JAX package asks ``jax.process_count()`` for its
shards, the port asks ``device.world_size``, which refuses more than one
process (ROADMAP.md, Queue 1 item 14).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np

from ..device import world_size
from ..registry import DATA_LOADERS
from ..utils.attr_dict import AttrDict
from .data_loader_wrapper import DataLoaderWrapper
from .loader import BatchIterator
from .module_parser import pad_to_length, pick_bucket
from .tokenization import SimpleTokenizer

logger = logging.getLogger(__name__)


class _ParquetDataset:
    """Row-access view over a parquet table (columns in memory)."""

    def __init__(self, path: str, dummy: bool = False):
        import pyarrow.parquet as pq

        table = pq.read_table(path)
        if dummy:
            table = table.slice(0, 64)
        self.columns = {
            name: table.column(name).to_pylist()
            for name in table.column_names
        }
        self.n = table.num_rows

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return {name: col[idx] for name, col in self.columns.items()}


@DATA_LOADERS.register()
class DataLoaderConceptualCaptions(DataLoaderWrapper):
    def LoadConceptualCaptions(self, module_config: Any) -> None:
        cfg = module_config.config
        paths = cfg.get("conceptual_captions_path", cfg)
        dummy = bool(self.config.data_loader.get("dummy_dataloader", 0))
        self.data.conceptual_captions = AttrDict(
            train=_ParquetDataset(paths["train"], dummy),
            val=_ParquetDataset(paths["val"], dummy),
        )
        logger.info(
            "[Data Statistics] CC train %d / val %d rows",
            len(self.data.conceptual_captions.train),
            len(self.data.conceptual_captions.val),
        )

    def collate_fn(self, batch: List[Dict]) -> AttrDict:
        """Tokenize captions; labels use -100 on padding
        (reference: data_loader_conceptual_captions.py:78-104). The
        reference stores caption/image_url as single-element lists — both
        layouts are accepted."""

        def first(value: Any) -> Any:
            return value[0] if isinstance(value, list) and value and isinstance(
                value[0], str
            ) else value

        image_urls = [first(s["image_url"]) for s in batch]
        captions = [first(s["caption"]) for s in batch]
        clip_embeddings = np.stack(
            [np.asarray(s["clip_embeddings"], dtype=np.float32).reshape(-1)
             for s in batch]
        )

        max_len = self.config.data_loader.additional.max_source_length
        enc = self.tokenizer(
            captions,
            padding="longest",
            max_length=max_len,
            truncation=True,
            return_tensors="np",
        )
        buckets = list(self.config.get("tpu", {}).get("length_buckets", [])) \
            or None
        target = pick_bucket(enc["input_ids"].shape[-1], buckets, max_len)
        pad_id = self.tokenizer.pad_token_id or 0
        input_ids = pad_to_length(np.asarray(enc["input_ids"]), target, pad_id)
        mask = pad_to_length(np.asarray(enc["attention_mask"]), target, 0)
        labels = np.where(input_ids == pad_id, -100, input_ids)

        return AttrDict(
            image_urls=image_urls,
            captions=captions,
            clip_embeddings=clip_embeddings,
            labels=labels,
            labels_attention_mask=mask,
        )

    def set_dataloader(self) -> None:
        cc = self.data.conceptual_captions
        additional = self.config.data_loader.additional
        # reference CC loader: 8 workers (data_loader_conceptual_captions.py
        # :119), 4 for the test loader. SimpleTokenizer numbers words in the
        # order it first meets them: one collate thread keeps that order,
        # and so the ids, the same from run to run
        num_workers = additional.get("num_workers", 8)
        num_workers_test = additional.get("num_workers_test", 4)
        if isinstance(self.tokenizer, SimpleTokenizer):
            num_workers = num_workers_test = 1
        # one process: its shard [0::1] is the whole set (the JAX package
        # shards by process here, world_size refuses that)
        shard_id, num_shards = 0, world_size()
        self.train_dataset = cc.train
        self.train_dataloader = BatchIterator(
            cc.train,
            batch_size=self.config.train.batch_size,
            collate_fn=self.collate_fn,
            shuffle=True,
            seed=self.config.seed,
            num_workers=num_workers,
            shard_id=shard_id,
            num_shards=num_shards,
        )
        self.test_dataset = cc.val
        self.test_dataloader = BatchIterator(
            cc.val,
            batch_size=self.config.valid.batch_size,
            collate_fn=self.collate_fn,
            shuffle=False,
            num_workers=num_workers_test,
            shard_id=shard_id,
            num_shards=num_shards,
        )
        logger.info(
            "[Data Statistics] train batches %d / test batches %d",
            len(self.train_dataloader), len(self.test_dataloader),
        )
