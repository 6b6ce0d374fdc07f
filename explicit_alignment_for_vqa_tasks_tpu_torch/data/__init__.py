"""The port's data side: the VQA2 and Conceptual Captions loaders
(registered in ``registry.DATA_LOADERS``), the VQA2 dataset
(``registry.DATASETS``), the ModuleParser, prompt templates, tokenizers and
the batch iterator; each the port's own copy of its namesake in
explicit_alignment_for_vqa_tasks_tpu/data/."""

from .data_loader_conceptual_captions import DataLoaderConceptualCaptions
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
    "DataLoaderConceptualCaptions",
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
