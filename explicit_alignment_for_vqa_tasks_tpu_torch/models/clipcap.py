"""ClipCap: a frozen GPT-2 with a mapping network's visual prefix prepended.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/clipcap.py
(:26-168). The mapper projects the CLIP embedding to ``prefix_length``
vectors in the LM's embedding space (in the embedding's dtype, fp32 for
CLIP's float32 embeddings, then cast to the LM's dtype);
they are prepended to the token embeddings, and positions run over prefix
and tokens. The teacher-forced loss ignores the prefix positions (-100) and
shifts by one, as HF does; generation is greedy with a KV cache
(``ops/decoding.py::greedy_decode_gpt2``). The loss's forward runs
``fused_gpt2_block`` per layer when ``cfg.lm.fused_block`` is set and the
sequence (prefix included) has at most 128 positions (``gpt2_forward``);
generation runs no kernel.

The JAX package registers the two model classes in its registry; here
``build_clipcap_model`` and ``build_clipcap_prefix`` are plain functions
(the registry and the model factory are ROADMAP Queue 1 item 7). Mapper
training is Queue 1 item 10: the loss is a forward pass here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..ops import decoding as _decoding
from . import gpt2 as gpt2_lib
from .mappers import MapperConfig, init_mapper, mapper_apply

Params = Dict[str, Any]
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class ClipCapConfig:
    lm: gpt2_lib.GPT2Config
    mapper: MapperConfig
    freeze_lm: bool = True

    @property
    def prefix_length(self) -> int:
        return self.mapper.prefix_length

    @classmethod
    def from_model_args(cls, model_args: Dict[str, Any],
                        lm_cfg: Optional[gpt2_lib.GPT2Config] = None,
                        freeze_lm: bool = True) -> "ClipCapConfig":
        """Build from the config file's ``model_config.model_args``
        (prefix_length / clip_length / prefix_size / mapping_type), GPT-2
        small by default."""
        lm = lm_cfg if lm_cfg is not None else gpt2_lib.GPT2Config.gpt2_small()
        mapper = MapperConfig(
            mapping_type=model_args.get("mapping_type", "mlp"),
            prefix_size=model_args.get("prefix_size", 512),
            d_model=lm.d_model,
            prefix_length=model_args.get("prefix_length", 10),
            clip_length=model_args.get(
                "clip_length", model_args.get("prefix_length", 10)
            ),
            num_layers=model_args.get("num_layers", 8),
        )
        return cls(lm=lm, mapper=mapper, freeze_lm=freeze_lm)


def init_clipcap_params(
    cfg: ClipCapConfig, seed: int = 0, device: DeviceLike = None,
    lm_params: Optional[Params] = None,
    param_dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """Random params drawn on ``device`` (the card by default) from a
    generator seeded with ``seed``: GPT-2 in ``param_dtype``, the mapper in
    fp32."""
    gen = make_generator(seed, resolve_device(device))
    if lm_params is None:
        lm_params = gpt2_lib.init_gpt2_params(gen, cfg.lm, param_dtype)
    return {"lm": lm_params, "mapper": init_mapper(gen, cfg.mapper)}


def embed_with_prefix(
    cfg: ClipCapConfig,
    lm_params: Params,
    mapper_params: Params,
    prefix: torch.Tensor,            # (B, prefix_size)
    input_ids: torch.Tensor,         # (B, L)
    attention_mask: torch.Tensor,    # (B, L)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[projected prefix; token embeddings] + positional embeddings.
    Returns (inputs_embeds (B, n + L, D), mask (B, n + L))."""
    n, d, dt = cfg.mapper.prefix_length, cfg.lm.d_model, cfg.lm.dtype
    batch = input_ids.shape[0]
    prefix_proj = mapper_apply(cfg.mapper, mapper_params, prefix)
    prefix_proj = prefix_proj.reshape(batch, n, d).to(dt)
    tok = lm_params["wte"].to(dt)[input_ids.long()]
    embeds = torch.cat([prefix_proj, tok], dim=1)
    total = embeds.shape[1]
    embeds = embeds + lm_params["wpe"].to(dt)[
        torch.arange(total, device=embeds.device)][None]
    mask = torch.cat(
        [torch.ones((batch, n), dtype=attention_mask.dtype,
                    device=attention_mask.device), attention_mask], dim=1)
    return embeds, mask


def clipcap_loss(
    mapper_params: Params,
    lm_params: Params,
    cfg: ClipCapConfig,
    prefix: torch.Tensor,            # (B, prefix_size)
    input_ids: torch.Tensor,         # (B, L)
    attention_mask: torch.Tensor,    # (B, L)
    labels: torch.Tensor,            # (B, L), -100 on ignored positions
    token_count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal-LM loss over [prefix; tokens]: the prefix positions are
    ignored, logits at t predict labels at t + 1, the fp32 log-softmax's
    negative log-likelihood is averaged over the valid positions (at least
    one), or divided by ``token_count`` (a data-parallel step's global
    count) where it is given. A 0-d fp32 tensor."""
    if cfg.freeze_lm:
        lm_params = {k: (v.detach() if torch.is_tensor(v) else
                         {n: a.detach() for n, a in v.items()})
                     for k, v in lm_params.items()}
    n = cfg.mapper.prefix_length
    batch = input_ids.shape[0]
    embeds, mask = embed_with_prefix(cfg, lm_params, mapper_params, prefix,
                                     input_ids, attention_mask)
    full_labels = torch.cat(
        [torch.full((batch, n), IGNORE_INDEX, dtype=labels.dtype,
                    device=labels.device), labels], dim=1)
    logits = gpt2_lib.gpt2_forward(lm_params, cfg.lm, inputs_embeds=embeds,
                                   attention_mask=mask)
    shifted_logits = logits[:, :-1]
    shifted_labels = full_labels[:, 1:]
    valid = shifted_labels != IGNORE_INDEX
    safe = torch.where(valid, shifted_labels, 0).long()
    log_probs = torch.log_softmax(shifted_logits.float(), dim=-1)
    ll = torch.gather(log_probs, -1, safe[..., None])[..., 0]
    divisor = valid.sum() if token_count is None else token_count
    return -(ll * valid).sum() / divisor.clamp(min=1)


class ClipCaptionModel:
    """Holds (cfg, params) and exposes the reference's model surface. Runs
    on the device that holds the params."""

    def __init__(self, cfg: ClipCapConfig, params: Params):
        self.cfg = cfg
        self.params = params
        self.device = params["lm"]["wte"].device

    def _on_device(self, *tensors):
        return tuple(torch.as_tensor(t, device=self.device) for t in tensors)

    def forward_loss(self, prefix, input_ids, attention_mask,
                     labels) -> torch.Tensor:
        prefix, input_ids, attention_mask, labels = self._on_device(
            prefix, input_ids, attention_mask, labels)
        return clipcap_loss(self.params["mapper"], self.params["lm"],
                            self.cfg, prefix, input_ids, attention_mask,
                            labels)

    @torch.inference_mode()
    def generate(
        self,
        prefix: torch.Tensor,            # (B, P, prefix_size): last is test
        question_tokens: torch.Tensor,   # (B, L)
        question_mask: torch.Tensor,     # (B, L)
        max_new_tokens: int = 20,
        eos_token_id: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy generation from [prefix; prompt]; returns (tokens (B, T)
        int32, token_logprobs (B, T) fp32). A 3-D prefix takes its last
        image, the test image's embedding."""
        prefix, tokens, mask = self._on_device(prefix, question_tokens,
                                               question_mask)
        if prefix.dim() == 3:
            prefix = prefix[:, -1]
        embeds, full_mask = embed_with_prefix(
            self.cfg, self.params["lm"], self.params["mapper"], prefix,
            tokens, mask)
        return _decoding.greedy_decode_gpt2(
            self.params["lm"], self.cfg.lm, embeds, full_mask,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id)


def build_clipcap_model(cfg: ClipCapConfig,
                        params: Params) -> ClipCaptionModel:
    """"ClipCaptionModel": the LM is trained with the mapper."""
    return ClipCaptionModel(dataclasses.replace(cfg, freeze_lm=False), params)


def build_clipcap_prefix(cfg: ClipCapConfig,
                         params: Params) -> ClipCaptionModel:
    """"ClipCaptionPrefix": the LM is frozen, only the mapper trains."""
    return ClipCaptionModel(dataclasses.replace(cfg, freeze_lm=True), params)
