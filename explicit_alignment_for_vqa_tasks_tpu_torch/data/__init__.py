"""The port's data side: the VQA2 loader (registered in
``registry.DATA_LOADERS``), its dataset (``registry.DATASETS``), the
ModuleParser, prompt templates, tokenizers and the batch iterator; each the
port's own copy of its namesake in explicit_alignment_for_vqa_tasks_tpu/data/.
The Conceptual Captions loader belongs to training and is not ported yet
(ROADMAP.md, Queue 1 item 10)."""

from .data_loader_vqa2 import DataLoaderVQA2
from .data_loader_wrapper import DataLoaderWrapper
from .in_context_examples import (
    FORMATS,
    InContextExampleFormatter,
    InContextExampleSelector,
)
from .loader import BatchIterator, ListDataset
from .module_parser import ModuleParser
from .tokenization import SimpleTokenizer, load_tokenizer
from .vqa2_datasets import VQA2Dataset

__all__ = [
    "BatchIterator",
    "DataLoaderVQA2",
    "DataLoaderWrapper",
    "FORMATS",
    "InContextExampleFormatter",
    "InContextExampleSelector",
    "ListDataset",
    "ModuleParser",
    "SimpleTokenizer",
    "VQA2Dataset",
    "load_tokenizer",
]
