"""Greedy decoding with per-token scores.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/decoding.py
(``greedy_decode_t5``, ``greedy_decode_from_cache``, ``greedy_decode_gpt2``,
``sequence_scores``). The JAX ``lax.while_loop`` becomes a host loop over
KV-cached decode steps that stops as soon as every row has emitted EOS;
slots after a row finishes hold pad tokens (GPT-2: EOS, its pad) with
log-prob 0, so the result equals the fixed-count loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import gpt2 as gpt2_lib
from ..models import t5 as t5_lib


def _not_ported(option: str) -> None:
    raise NotImplementedError(
        f"{option} is not ported yet (ROADMAP.md, Queue 1 item 5)")


def greedy_decode_t5(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    encoder_hidden: torch.Tensor,     # (B, L, D)
    encoder_mask: torch.Tensor,       # (B, L)
    max_new_tokens: int = 20,
    force_eos_at: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy seq2seq decode from precomputed encoder states.

    Returns (tokens (B, T) int32, token_logprobs (B, T) f32). Rows stop at
    EOS; later slots are pad with log-prob 0."""
    if force_eos_at is not None:
        _not_ported("force_eos_at")
    cache = t5_lib.init_decode_cache(params, cfg, encoder_hidden,
                                     max_new_tokens)
    return greedy_decode_from_cache(params, cfg, cache, encoder_mask,
                                    max_new_tokens)


def greedy_decode_from_cache(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    cache: Dict[str, Any],
    encoder_mask: torch.Tensor,       # (B, L)
    max_new_tokens: int = 20,
    force_eos_at: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``greedy_decode_t5``'s loop from a prebuilt decode cache."""
    if force_eos_at is not None:
        _not_ported("force_eos_at")
    batch = encoder_mask.shape[0]
    dev = encoder_mask.device
    buf = torch.full((batch, max_new_tokens), cfg.pad_token_id,
                     dtype=torch.int32, device=dev)
    lp_buf = torch.zeros((batch, max_new_tokens), dtype=torch.float32,
                         device=dev)
    token = torch.full((batch,), cfg.decoder_start_token_id,
                       dtype=torch.int32, device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    for t in range(max_new_tokens):
        if bool(finished.all()):
            break
        logits, cache = t5_lib.t5_decode_step(params, cfg, token, cache,
                                              encoder_mask)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        # argmax returns the first maximal index, as jnp.argmax does
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        next_token = torch.where(finished, cfg.pad_token_id, next_token)
        token_lp = torch.gather(log_probs, 1, next_token[:, None].long())[:, 0]
        token_lp = torch.where(finished, 0.0, token_lp)
        finished = finished | (next_token == cfg.eos_token_id)
        buf[:, t] = next_token
        lp_buf[:, t] = token_lp
        token = next_token
    return buf, lp_buf


def greedy_decode_gpt2(
    params: Dict[str, Any],
    cfg: gpt2_lib.GPT2Config,
    inputs_embeds: torch.Tensor,      # (B, L, D) prompt incl. prefix + pos emb
    attention_mask: torch.Tensor,     # (B, L)
    max_new_tokens: int = 20,
    eos_token_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoder-only generation from an embedded prompt: prefill, then
    one KV-cached step per token (JAX :253-303).

    Returns (tokens (B, T) int32, token_logprobs (B, T) f32). A row's first
    EOS is recorded with its log-prob; later slots hold EOS (GPT-2's pad)
    with log-prob 0."""
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    batch, prompt_len, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    cache = gpt2_lib.init_gpt2_cache(cfg, batch, prompt_len + max_new_tokens,
                                     device=dev)
    full_mask = torch.cat(
        [attention_mask, torch.ones((batch, max_new_tokens),
                                    dtype=attention_mask.dtype, device=dev)],
        dim=1)
    logits, cache = gpt2_lib.gpt2_prefill(params, cfg, inputs_embeds,
                                          attention_mask, cache)
    buf = torch.full((batch, max_new_tokens), eos, dtype=torch.int32,
                     device=dev)
    lp_buf = torch.zeros((batch, max_new_tokens), dtype=torch.float32,
                         device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    for t in range(max_new_tokens):
        if bool(finished.all()):
            break
        log_probs = torch.log_softmax(logits, dim=-1)
        # argmax returns the first maximal index, as jnp.argmax does
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        next_token = torch.where(finished, eos, next_token)
        token_lp = torch.gather(log_probs, 1, next_token[:, None].long())[:, 0]
        token_lp = torch.where(finished, 0.0, token_lp)
        finished = finished | (next_token == eos)
        buf[:, t] = next_token
        lp_buf[:, t] = token_lp
        if t + 1 < max_new_tokens and not bool(finished.all()):
            logits, cache = gpt2_lib.gpt2_decode_step(params, cfg, next_token,
                                                      cache, full_mask)
    return buf, lp_buf


def sequence_scores(
    tokens: torch.Tensor,          # (B, T)
    token_logprobs: torch.Tensor,  # (B, T)
    skip_token_ids: Tuple[int, ...] = (0, 1, 2),
) -> torch.Tensor:
    """Sum of generated-token log-probs, skipping special ids — the
    ensemble-member score."""
    skip = torch.zeros_like(tokens, dtype=torch.bool)
    for tid in skip_token_ids:
        skip = skip | (tokens == tid)
    return torch.where(skip, 0.0, token_logprobs).sum(dim=-1)
