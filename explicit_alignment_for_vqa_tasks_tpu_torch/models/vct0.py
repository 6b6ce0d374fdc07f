"""VC-T0: frozen T5/T0 LM + mapping network + prefix splicing.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/vct0.py's
generate surface, under any ``T5Config`` option:
  - main: embed the prompt, project the CLIP prefixes, splice them in at
    the sentinels, encode once, decode with a KV cache (greedy, beam
    search, ``force_eos_at``, or the prefill in batch chunks);
  - ``no_prefix``: the text-only prompt;
  - one-at-a-time: each segment (shot) encoded apart with its own
    sentinel <extra_id_i>, the states concatenated for the decoder;
  - a forced decoder prefix, teacher-forced before the greedy decode;
  - prefix-only captioning.
``vct0_caption_loss`` is the mapper's training loss (the prefix alone as
the encoder input, the frozen LM teacher forced on the caption).
The opt-in int8 modes are quantized at build time
(``quantize_int8_encoder``) or, for the encoder, after SmoothQuant
calibration on eval batches (``VCT0Model.calibrate_and_quantize_int8``).
The pipelined generate paths raise ``NotImplementedError`` naming their
ROADMAP item. ``build_vct0_model`` and ``build_vct0_prefix`` are
registered in ``registry.MODELS`` under the config's ``ModelClass`` names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..ops import decoding as _decoding
from ..ops.prefix_splice import T5_SENTINEL_BASE, insert_prefix_into_input
from ..parallel.gather import max_across_processes
from ..registry import MODELS
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
    in fp32. The perceiver's latents are the embeddings of
    ``prefix_length`` vocabulary ids drawn uniformly (JAX
    ``init_vct0_params``, :84-93)."""
    gen = make_generator(seed, resolve_device(device))
    if lm_params is None:
        lm_params = t5_lib.init_t5_params(gen, cfg.lm, param_dtype)
    latents_init = None
    if cfg.mapper.mapping_type == "perceiver":
        idx = torch.randint(0, cfg.lm.vocab_size, (cfg.mapper.prefix_length,),
                            generator=gen, device=gen.device)
        latents_init = lm_params["shared"][idx].float()
    return {"lm": lm_params,
            "mapper": init_mapper(gen, cfg.mapper, latents_init=latents_init)}


def quantize_int8_encoder(lm_params: Params,
                          lm_cfg: t5_lib.T5Config) -> Params:
    """The LM params quantized for every int8 mode ``lm_cfg`` enables,
    once, at build time with ``groups="auto"``, as the JAX package's model
    factory does when no calibration batches are configured
    (``trainers/model_factory.py:182-201``): the encoder FFN and attention
    projections (W8A8), and the decode step's weights (W8A16, with the
    bf16 decoder weights they replace dropped). Returns a new dict;
    ``lm_params`` is not changed."""
    if lm_cfg.int8_encoder_ffn:
        lm_params = t5_lib.quantize_encoder_ffn(lm_params)
    if lm_cfg.int8_encoder_attn:
        lm_params = t5_lib.quantize_encoder_attn(lm_params)
    if lm_cfg.int8_decoder_step:
        lm_params = t5_lib.quantize_decoder_step(lm_params, drop_bf16=True)
    return lm_params


def project_prefix(cfg: VCT0Config, mapper_params: Params,
                   prefix: torch.Tensor) -> torch.Tensor:
    """(B, P, prefix_size) -> (B, P, prefix_length, d_model)."""
    flat = mapper_apply(cfg.mapper, mapper_params, prefix)
    return flat.reshape(*prefix.shape[:-1], cfg.mapper.prefix_length,
                        cfg.lm.d_model)


def _frozen(lm_params: Params) -> Params:
    """The LM tree with every tensor detached: no gradient reaches it."""
    return {k: _frozen(v) if isinstance(v, dict) else v.detach()
            for k, v in lm_params.items()}


def vct0_caption_loss(
    mapper_params: Params,
    lm_params: Params,
    cfg: VCT0Config,
    clip_embeddings: torch.Tensor,   # (B, prefix_size)
    labels: torch.Tensor,            # (B, T), -100 on padding
    token_count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Captioning loss with the projected prefix as the whole encoder input
    (JAX models/vct0.py:112-130; reference: vct0.py:380-394): the mapper's
    fp32 output as (B, prefix_length, d_model) in the LM's dtype,
    ``t5_forward_loss`` on it (divided by ``token_count``, the global
    batch's valid tokens, where it is given). With ``freeze_lm`` the LM is
    detached, so only the mapper gets gradients. A 0-d fp32 tensor."""
    if cfg.freeze_lm:
        lm_params = _frozen(lm_params)
    flat = mapper_apply(cfg.mapper, mapper_params, clip_embeddings)
    prefix_embeds = flat.reshape(-1, cfg.mapper.prefix_length,
                                 cfg.lm.d_model).to(cfg.lm.dtype)
    return t5_lib.t5_forward_loss(lm_params, cfg.lm, labels,
                                  inputs_embeds=prefix_embeds,
                                  token_count=token_count)


def _splice(lm_params: Params, cfg: VCT0Config, prefix_proj: torch.Tensor,
            tokens: torch.Tensor, mask: torch.Tensor, num_prefixes: int,
            base_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prompt's embeddings with the projected prefixes (the mapper's
    fp32, cast to the text embeddings' dtype) spliced in at sentinels
    base_id, base_id - 1, ..."""
    text_embeds = t5_lib.embed_tokens(lm_params, cfg.lm, tokens)
    return insert_prefix_into_input(
        tokens, text_embeds, prefix_proj.to(text_embeds.dtype), mask,
        prefix_length=cfg.prefix_length, num_prefixes=num_prefixes,
        base_id=base_id,
    )


def _decode(lm_params: Params, cfg: VCT0Config, hidden: torch.Tensor,
            mask: torch.Tensor, max_new_tokens: int, num_beams: int = 1,
            force_eos_at: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if num_beams > 1:
        # the winner's true per-token log-probs: sequence_scores ranks
        # beam outputs as it ranks greedy ones
        return _decoding.beam_search_t5(lm_params, cfg.lm, hidden, mask,
                                        num_beams=num_beams,
                                        max_new_tokens=max_new_tokens)
    return _decoding.greedy_decode_t5(lm_params, cfg.lm, hidden, mask,
                                      max_new_tokens,
                                      force_eos_at=force_eos_at)


def _generate_main(
    lm_params: Params, mapper_params: Params, cfg: VCT0Config,
    prefix: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
    num_prefixes: int, max_new_tokens: int, num_beams: int = 1,
    force_eos_at: Optional[torch.Tensor] = None, prefill_chunks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    joint, joint_mask = _splice(
        lm_params, cfg, project_prefix(cfg, mapper_params, prefix), tokens,
        mask, num_prefixes, cfg.sentinel_base)
    if prefill_chunks > 1:
        if num_beams > 1:
            raise ValueError(
                "prefill_chunks > 1 is greedy-only (beam search expands "
                "the batch before the cache is built)")
        return _decoding.chunked_prefill_greedy_decode_t5(
            lm_params, cfg.lm, joint, joint_mask, max_new_tokens,
            prefill_chunks=prefill_chunks, force_eos_at=force_eos_at)
    hidden = t5_lib.t5_encode(
        lm_params, cfg.lm, inputs_embeds=joint, attention_mask=joint_mask
    )
    return _decode(lm_params, cfg, hidden, joint_mask, max_new_tokens,
                   num_beams, force_eos_at)


def _generate_no_prefix(
    lm_params: Params, cfg: VCT0Config, tokens: torch.Tensor,
    mask: torch.Tensor, max_new_tokens: int, num_beams: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    hidden = t5_lib.t5_encode(lm_params, cfg.lm, input_ids=tokens,
                              attention_mask=mask)
    return _decode(lm_params, cfg, hidden, mask, max_new_tokens, num_beams)


def _generate_prefix_only(
    lm_params: Params, mapper_params: Params, cfg: VCT0Config,
    prefix: torch.Tensor, max_new_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Captioning: the P projected prefixes alone are the encoder input
    (P x prefix_length positions)."""
    prefix_proj = project_prefix(cfg, mapper_params, prefix)
    prefix_embeds = prefix_proj.reshape(
        prefix.shape[0], -1, cfg.lm.d_model).to(cfg.lm.dtype)
    mask = torch.ones(prefix_embeds.shape[:2], dtype=torch.int32,
                      device=prefix_embeds.device)
    hidden = t5_lib.t5_encode(lm_params, cfg.lm, inputs_embeds=prefix_embeds,
                              attention_mask=mask)
    return _decode(lm_params, cfg, hidden, mask, max_new_tokens)


def _generate_forced(
    lm_params: Params, mapper_params: Params, cfg: VCT0Config,
    prefix: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
    decoder_input_ids: torch.Tensor, max_new_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Only the test image's prefix (the last) is spliced (reference:
    vct0.py:466-482)."""
    prefix_proj = project_prefix(cfg, mapper_params, prefix)
    joint, joint_mask = _splice(lm_params, cfg, prefix_proj[:, -1:], tokens,
                                mask, 1, cfg.sentinel_base)
    hidden = t5_lib.t5_encode(
        lm_params, cfg.lm, inputs_embeds=joint, attention_mask=joint_mask
    )
    return _decoding.forced_decode_t5(lm_params, cfg.lm, hidden, joint_mask,
                                      decoder_input_ids, max_new_tokens)


def _one_at_a_time_segments(
    lm_params: Params, mapper_params: Params, cfg: VCT0Config,
    prefix: Optional[torch.Tensor], tokens: torch.Tensor,
    mask: torch.Tensor, num_segments: int, with_prefix: bool,
):
    """Each segment's encoder input (reference: vct0.py:427-444): with
    ``with_prefix``, segment i's prompt with prefix i spliced in at its
    sentinel <extra_id_i> = sentinel_base - i, else its text embeddings.
    Yields (inputs_embeds, mask) per segment."""
    prefix_proj = (project_prefix(cfg, mapper_params, prefix)
                   if with_prefix else None)
    for i in range(num_segments):
        seg_tokens, seg_mask = tokens[:, i], mask[:, i]
        if with_prefix:
            yield _splice(lm_params, cfg, prefix_proj[:, i:i + 1], seg_tokens,
                          seg_mask, 1, cfg.sentinel_base - i)
        else:
            yield (t5_lib.embed_tokens(lm_params, cfg.lm, seg_tokens),
                   seg_mask)


def _generate_one_at_a_time(
    lm_params: Params, mapper_params: Params, cfg: VCT0Config,
    prefix: Optional[torch.Tensor], tokens: torch.Tensor, mask: torch.Tensor,
    num_segments: int, max_new_tokens: int, with_prefix: bool,
    num_beams: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise encoder: the S segments share one shape, so they are
    stacked on the batch axis into ONE encode of S*B rows (encoder rows are
    independent), then laid out again as (B, S*L, D) for the decoder, the
    mask to match."""
    seg_inputs, seg_masks = zip(*_one_at_a_time_segments(
        lm_params, mapper_params, cfg, prefix, tokens, mask, num_segments,
        with_prefix))
    stacked_mask = torch.cat(seg_masks, dim=0)                  # (S*B, L)
    hidden = t5_lib.t5_encode(lm_params, cfg.lm,
                              inputs_embeds=torch.cat(seg_inputs, dim=0),
                              attention_mask=stacked_mask)
    batch, seg_len = tokens.shape[0], hidden.shape[1]
    encoder_hidden = hidden.reshape(num_segments, batch, seg_len, -1) \
        .transpose(0, 1).reshape(batch, num_segments * seg_len, -1)
    encoder_mask = stacked_mask.reshape(num_segments, batch, seg_len) \
        .transpose(0, 1).reshape(batch, num_segments * seg_len)
    return _decode(lm_params, cfg, encoder_hidden, encoder_mask,
                   max_new_tokens, num_beams)


class VCT0Model:
    """Holds (cfg, params) and exposes the reference's generate surface.
    Runs on the device that holds the params."""

    def __init__(self, cfg: VCT0Config, params: Params):
        self.cfg = cfg
        self.params = params
        self.device = params["lm"]["shared"].device
        # the JAX package's (mesh, n_micro, sequence_parallel) of a
        # pipelined mesh; its generate twins are not ported
        self.pipeline_ctx = None

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
        """Returns (tokens (B, T) int32, token_logprobs (B, T) fp32). With
        num_beams > 1 the log-probs are the winning hypothesis's true
        per-token values, so ``score_sequences`` ranks greedy and beam
        outputs alike. Inputs may be tensors or arrays; they are moved to
        the params' device.

        One-at-a-time takes (B, S, L) tokens and mask and (B, S, size)
        prefixes. ``force_eos_at`` ((B,) int32, the bench's
        --eos_at_steps) and ``prefill_chunks`` > 1 (the prefill in batch
        chunks, value-equal) are for the main greedy path only."""
        main_greedy_only = (
            num_beams > 1 or no_prefix or decoder_input_ids is not None
            or pass_examples_through_encoder_one_at_a_time
            or self.pipeline_ctx is not None or question_tokens is None)
        if force_eos_at is not None and main_greedy_only:
            raise ValueError(
                "force_eos_at is a bench hook for the main single-device "
                "greedy generate path only")
        if prefill_chunks > 1 and main_greedy_only:
            raise ValueError(
                "prefill_chunks > 1 is supported on the main single-device "
                "greedy generate path only")
        if num_beams > 1 and decoder_input_ids is not None:
            # forced_decode_t5 continues greedily after teacher forcing
            raise ValueError(
                "num_beams > 1 with a forced decoder prefix "
                "(decoder_input_modules) is not implemented — the forced "
                "path continues greedily after teacher forcing; set "
                "num_beams=1 or drop decoder_input_modules")
        if num_beams > 1 and question_tokens is None:
            raise ValueError(
                "num_beams > 1 is not supported on the prefix-only "
                "captioning path (greedy decode only)")
        if self.pipeline_ctx is not None:
            raise NotImplementedError(
                "VCT0Model.generate: the pipelined generate paths (the _pp "
                "twins) are not ported yet (ROADMAP.md, Queue 1 item 14, "
                "the pipeline)")
        dev = self.device

        def on_device(x):
            return None if x is None else torch.as_tensor(x, device=dev)

        prefix, tokens = on_device(prefix), on_device(question_tokens)
        mask = on_device(question_mask)
        if mask is not None:
            mask = mask.to(torch.int32)
        lm_params, mapper_params = self.params["lm"], self.params["mapper"]
        cfg = self.cfg
        if pass_examples_through_encoder_one_at_a_time:
            return _generate_one_at_a_time(
                lm_params, mapper_params, cfg, None if no_prefix else prefix,
                tokens, mask, num_segments=tokens.shape[1],
                max_new_tokens=max_new_tokens, with_prefix=not no_prefix,
                num_beams=num_beams)
        if no_prefix:
            return _generate_no_prefix(lm_params, cfg, tokens, mask,
                                       max_new_tokens, num_beams)
        if tokens is None:
            # prefix-only captioning (reference: vct0.py:484-491)
            return _generate_prefix_only(lm_params, mapper_params, cfg,
                                         prefix, max_new_tokens)
        if decoder_input_ids is not None:
            return _generate_forced(lm_params, mapper_params, cfg, prefix,
                                    tokens, mask,
                                    on_device(decoder_input_ids),
                                    max_new_tokens)
        num_prefixes = prefix.shape[1] if num_shots is None else num_shots + 1
        return _generate_main(
            lm_params, mapper_params, cfg, prefix, tokens, mask,
            num_prefixes=num_prefixes, max_new_tokens=max_new_tokens,
            num_beams=num_beams, force_eos_at=on_device(force_eos_at),
            prefill_chunks=prefill_chunks)

    def score_sequences(self, tokens: torch.Tensor,
                        token_logprobs: torch.Tensor) -> torch.Tensor:
        return _decoding.sequence_scores(tokens, token_logprobs)

    # --- int8 SmoothQuant calibration (deferred quantization) ---------
    @torch.inference_mode()
    def encoder_calibration_batch(
        self,
        prefix: Optional[torch.Tensor] = None,
        question_tokens: Optional[torch.Tensor] = None,
        question_mask: Optional[torch.Tensor] = None,
        no_prefix: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The spliced encoder inputs (embeds, mask) of one eval batch: the
        calibration surface of the int8 modes. Covers the main spliced
        path and no_prefix (text embeddings only)."""
        lm_params, mapper_params = self.params["lm"], self.params["mapper"]
        dev = self.device
        tokens = torch.as_tensor(question_tokens, device=dev)
        mask = torch.as_tensor(question_mask, device=dev).to(torch.int32)
        text_embeds = t5_lib.embed_tokens(lm_params, self.cfg.lm, tokens)
        if no_prefix or prefix is None:
            return text_embeds, mask
        if tokens.dim() != 2:
            raise ValueError(
                "int8 calibration supports the main spliced eval path "
                "(2-D question tokens); for other modes calibrate via "
                "models.t5.calibrate_encoder_act_max")
        prefix = torch.as_tensor(prefix, device=dev)
        prefix_proj = project_prefix(self.cfg, mapper_params, prefix)
        return insert_prefix_into_input(
            tokens, text_embeds, prefix_proj.to(text_embeds.dtype), mask,
            prefix_length=self.cfg.prefix_length,
            num_prefixes=prefix.shape[1], base_id=self.cfg.sentinel_base,
        )

    def calibrate_and_quantize_int8(self, batches, alpha: float = 0.5,
                                    groups="auto") -> Dict[str, Any]:
        """One-shot SmoothQuant calibration and int8 quantization of the
        frozen LM encoder, on real eval batches; with int8_decoder_step the
        decode step's weights are quantized too, as the JAX package does
        (``vct0.py:814-818``; weight-only, no statistics). ``batches``:
        iterable of dicts of ``encoder_calibration_batch``'s arguments.
        Returns the act-max statistics and swaps the quantized LM params
        into ``self.params``. Over several processes each calibrates on its
        shard and the statistics are max-reduced across them before the
        folding (JAX ``vct0.py:793-801``), so every rank's quantized weights
        are bit-equal."""
        lm_cfg = self.cfg.lm
        if not (lm_cfg.int8_encoder_ffn or lm_cfg.int8_encoder_attn):
            raise ValueError(
                "calibrate_and_quantize_int8 needs an int8 encoder mode "
                "enabled (int8_encoder_ffn / int8_encoder_attn)")
        stats = None
        for b in batches:
            emb, m = self.encoder_calibration_batch(**b)
            cur = t5_lib.calibrate_encoder_act_max(
                self.params["lm"], lm_cfg, [(emb, m)])
            stats = cur if stats is None else {
                k: torch.maximum(stats[k], cur[k]) for k in stats}
        if stats is None:
            raise ValueError("int8 calibration needs >= 1 batch")
        stats = {k: max_across_processes(v) for k, v in stats.items()}
        lm = self.params["lm"]
        if lm_cfg.int8_encoder_ffn:
            lm = t5_lib.quantize_encoder_ffn(
                lm, groups=groups, act_max=stats["ffn"], alpha=alpha)
        if lm_cfg.int8_encoder_attn:
            lm = t5_lib.quantize_encoder_attn(
                lm, groups=groups, act_max=stats["attn"], alpha=alpha)
        if lm_cfg.int8_decoder_step and "step_q8" not in lm["decoder"]:
            lm = t5_lib.quantize_decoder_step(lm, groups=groups,
                                              drop_bf16=True)
        self.params = dict(self.params)
        self.params["lm"] = lm
        return stats


@MODELS.register("VCT0Model")
def build_vct0_model(cfg: VCT0Config, params: Params) -> VCT0Model:
    return VCT0Model(dataclasses.replace(cfg, freeze_lm=False), params)


@MODELS.register("VCT0Prefix")
def build_vct0_prefix(cfg: VCT0Config, params: Params) -> VCT0Model:
    """Frozen-LM variant (reference: vct0.py:535-544): only
    params['mapper'] is trainable."""
    return VCT0Model(dataclasses.replace(cfg, freeze_lm=True), params)
