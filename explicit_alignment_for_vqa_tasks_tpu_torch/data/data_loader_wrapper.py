"""DataLoaderWrapper base: tokenizer setup + dataset-module dispatch
(reference: src/data_loader_manager/data_loader_wrapper.py:30-134).

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/data/data_loader_wrapper.py, held
against it by tests/test_torch_eval_data.py.
"""

from __future__ import annotations

import logging
from typing import Any

from ..utils.attr_dict import AttrDict
from .tokenization import load_tokenizer

logger = logging.getLogger(__name__)


class DataLoaderWrapper:
    """Instantiates tokenizer(s) from config class names, then runs the
    configured `dataset_modules` loader methods by name."""

    def __init__(self, config: Any):
        self.config = config
        self.data = AttrDict()
        self.feature_extractor = None
        self.image_preprocessor = None
        self.train_dataloader = None
        self.test_dataloader = None

        model_config = config.model_config
        special_tokens = model_config.get("SPECIAL_TOKENS", {})
        self.tokenizer = load_tokenizer(
            model_config.TokenizerClass,
            model_config.TokenizerModelVersion,
            special_tokens,
        )
        if model_config.get("DecoderTokenizerClass"):
            self.decoder_tokenizer = load_tokenizer(
                model_config.DecoderTokenizerClass,
                model_config.DecoderTokenizerModelVersion,
                model_config.get("DECODER_SPECIAL_TOKENS", {}),
            )
        else:
            self.decoder_tokenizer = self.tokenizer

        if model_config.get("FeatureExtractorClass"):
            import transformers

            cls = getattr(transformers, model_config.FeatureExtractorClass)
            self.feature_extractor = cls.from_pretrained(
                model_config.FeatureExtractorModelVersion,
                local_files_only=True,
            )

    def build_dataset(self) -> None:
        """Run each configured dataset-module loader in order
        (reference: data_loader_wrapper.py:117-134)."""
        modules = self.config.data_loader.dataset_modules.module_list
        module_dict = self.config.data_loader.dataset_modules.module_dict
        for name in modules:
            module_config = module_dict[name]
            logger.info("loading dataset module %s", name)
            getattr(self, name)(module_config)

    def set_dataloader(self) -> None:  # implemented by subclasses
        raise NotImplementedError
