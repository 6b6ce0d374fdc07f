"""VC-T0: frozen T5/T0 LM + mapping network + prefix splicing.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/vct0.py,
restricted to the main generate path with greedy decoding: embed the
prompt, project the CLIP prefixes, splice them in at the sentinels, encode
once and decode greedily with a KV cache. The other modes raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..ops import decoding as _decoding
from ..ops.prefix_splice import T5_SENTINEL_BASE, insert_prefix_into_input
from . import t5 as t5_lib
from .mappers import MapperConfig, init_mapper, mapper_apply

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VCT0Config:
    lm: t5_lib.T5Config
    mapper: MapperConfig
    freeze_lm: bool = True
    # id of <extra_id_0>; <extra_id_i> = sentinel_base - i
    sentinel_base: int = T5_SENTINEL_BASE

    @property
    def prefix_length(self) -> int:
        return self.mapper.prefix_length

    @classmethod
    def from_model_args(cls, model_args: Dict[str, Any],
                        lm_cfg: Optional[t5_lib.T5Config] = None,
                        freeze_lm: bool = True) -> "VCT0Config":
        """Build from the config-file ``model_config.model_args`` schema
        (prefix_length / prefix_size / mapping_type / model_version)."""
        lm = lm_cfg if lm_cfg is not None else t5_lib.T5Config.t0_3b()
        mapper = MapperConfig(
            mapping_type=model_args.get("mapping_type", "mlp"),
            prefix_size=model_args.get("prefix_size", 768),
            d_model=lm.d_model,
            prefix_length=model_args.get("prefix_length", 10),
            clip_length=model_args.get(
                "clip_length", model_args.get("prefix_length", 10)
            ),
            num_layers=model_args.get("num_layers", 8),
        )
        return cls(
            lm=lm, mapper=mapper, freeze_lm=freeze_lm,
            sentinel_base=model_args.get("sentinel_base", T5_SENTINEL_BASE),
        )


def init_vct0_params(
    cfg: VCT0Config, seed: int = 0, device: DeviceLike = None,
    lm_params: Optional[Params] = None,
    param_dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """Random params drawn on ``device`` (the card by default) from a
    generator seeded with ``seed``: the LM in ``param_dtype``, the mapper
    in fp32."""
    gen = make_generator(seed, resolve_device(device))
    if lm_params is None:
        lm_params = t5_lib.init_t5_params(gen, cfg.lm, param_dtype)
    return {"lm": lm_params, "mapper": init_mapper(gen, cfg.mapper)}


def project_prefix(cfg: VCT0Config, mapper_params: Params,
                   prefix: torch.Tensor) -> torch.Tensor:
    """(B, P, prefix_size) -> (B, P, prefix_length, d_model)."""
    flat = mapper_apply(cfg.mapper, mapper_params, prefix)
    return flat.reshape(*prefix.shape[:-1], cfg.mapper.prefix_length,
                        cfg.lm.d_model)


def _generate_main(
    lm_params: Params, mapper_params: Params, cfg: VCT0Config,
    prefix: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
    num_prefixes: int, max_new_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    text_embeds = t5_lib.embed_tokens(lm_params, cfg.lm, tokens)
    # the mapper runs in fp32 and is cast to the text embeddings' dtype
    prefix_proj = project_prefix(cfg, mapper_params, prefix)
    joint, joint_mask = insert_prefix_into_input(
        tokens, text_embeds, prefix_proj.to(text_embeds.dtype), mask,
        prefix_length=cfg.prefix_length, num_prefixes=num_prefixes,
        base_id=cfg.sentinel_base,
    )
    hidden = t5_lib.t5_encode(
        lm_params, cfg.lm, inputs_embeds=joint, attention_mask=joint_mask
    )
    return _decoding.greedy_decode_t5(lm_params, cfg.lm, hidden, joint_mask,
                                      max_new_tokens)


def _not_ported(mode: str, item: str) -> None:
    raise NotImplementedError(
        f"VCT0Model.generate: {mode} is not ported yet (ROADMAP.md, {item})")


class VCT0Model:
    """Holds (cfg, params) and exposes the reference's generate surface.
    Runs on the device that holds the params."""

    def __init__(self, cfg: VCT0Config, params: Params):
        self.cfg = cfg
        self.params = params
        self.device = params["lm"]["shared"].device

    @torch.inference_mode()
    def generate(
        self,
        prefix: Optional[torch.Tensor] = None,        # (B, P, prefix_size)
        question_tokens: Optional[torch.Tensor] = None,
        question_mask: Optional[torch.Tensor] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,
        no_prefix: bool = False,
        pass_examples_through_encoder_one_at_a_time: bool = False,
        num_shots: Optional[int] = None,
        max_new_tokens: int = 20,
        num_beams: int = 1,
        force_eos_at: Optional[torch.Tensor] = None,
        prefill_chunks: int = 1,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (tokens (B, T) int32, token_logprobs (B, T) fp32).
        Inputs may be tensors or arrays; they are moved to the params'
        device."""
        if num_beams > 1:
            _not_ported("num_beams > 1", "Queue 1 item 5")
        if force_eos_at is not None:
            _not_ported("force_eos_at", "Queue 1 item 5")
        if prefill_chunks > 1:
            _not_ported("prefill_chunks > 1", "Queue 1 item 5")
        if no_prefix:
            _not_ported("no_prefix", "Queue 1 item 6")
        if pass_examples_through_encoder_one_at_a_time:
            _not_ported("one-at-a-time encoding", "Queue 1 item 6")
        if question_tokens is None:
            _not_ported("prefix-only captioning", "Queue 1 item 6")
        if decoder_input_ids is not None:
            _not_ported("a forced decoder prefix", "Queue 1 item 6")
        dev = self.device
        prefix = torch.as_tensor(prefix, device=dev)
        tokens = torch.as_tensor(question_tokens, device=dev)
        mask = torch.as_tensor(question_mask, device=dev)
        num_prefixes = prefix.shape[1] if num_shots is None else num_shots + 1
        return _generate_main(
            self.params["lm"], self.params["mapper"], self.cfg, prefix,
            tokens, mask.to(torch.int32), num_prefixes=num_prefixes,
            max_new_tokens=max_new_tokens,
        )

    def score_sequences(self, tokens: torch.Tensor,
                        token_logprobs: torch.Tensor) -> torch.Tensor:
        return _decoding.sequence_scores(tokens, token_logprobs)
