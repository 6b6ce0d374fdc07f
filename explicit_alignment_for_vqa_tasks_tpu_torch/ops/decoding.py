"""Autoregressive decoding loops with per-token scores.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/decoding.py
(``greedy_decode_t5``, ``greedy_decode_from_cache``,
``encode_and_greedy_decode_t5``, ``chunked_prefill_greedy_decode_t5``,
``forced_decode_t5``, ``beam_search_t5``, ``greedy_decode_gpt2``,
``sequence_scores``). Each JAX ``lax.while_loop`` becomes a host loop over
KV-cached decode steps that stops as soon as every row (beam) has emitted
EOS; slots after a row finishes hold pad tokens (GPT-2: EOS, its pad) with
log-prob 0, so the result equals the fixed-count loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import gpt2 as gpt2_lib
from ..models import t5 as t5_lib


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
    EOS; later slots are pad with log-prob 0. ``force_eos_at`` ((B,)
    int32, the bench's --eos_at_steps) finishes row b after step
    force_eos_at[b], so that the early exit can be timed at a chosen
    answer-length distribution (random weights never emit EOS)."""
    cache = t5_lib.init_decode_cache(params, cfg, encoder_hidden,
                                     max_new_tokens)
    return greedy_decode_from_cache(params, cfg, cache, encoder_mask,
                                    max_new_tokens, force_eos_at)


def _greedy_pick(logits: torch.Tensor, finished: torch.Tensor,
                 pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's token (pad for finished rows) and its fp32 log-prob (0
    for finished rows)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    next_token = torch.where(finished, pad, next_token)
    token_lp = torch.gather(log_probs, 1, next_token[:, None].long())[:, 0]
    return next_token, torch.where(finished, 0.0, token_lp)


def greedy_decode_from_cache(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    cache: Dict[str, Any],
    encoder_mask: torch.Tensor,       # (B, L)
    max_new_tokens: int = 20,
    force_eos_at: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``greedy_decode_t5``'s loop from a prebuilt decode cache
    (``t5.init_decode_cache`` or ``chunked_prefill_greedy_decode_t5``'s)."""
    batch = encoder_mask.shape[0]
    dev = encoder_mask.device
    buf = torch.full((batch, max_new_tokens), cfg.pad_token_id,
                     dtype=torch.int32, device=dev)
    lp_buf = torch.zeros((batch, max_new_tokens), dtype=torch.float32,
                         device=dev)
    token = torch.full((batch,), cfg.decoder_start_token_id,
                       dtype=torch.int32, device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    if force_eos_at is not None:
        force_eos_at = torch.as_tensor(force_eos_at, device=dev)
    for t in range(max_new_tokens):
        if bool(finished.all()):
            break
        logits, cache = t5_lib.t5_decode_step(params, cfg, token, cache,
                                              encoder_mask)
        next_token, token_lp = _greedy_pick(logits, finished,
                                            cfg.pad_token_id)
        finished = finished | (next_token == cfg.eos_token_id)
        if force_eos_at is not None:
            finished = finished | (force_eos_at <= t + 1)
        buf[:, t] = next_token
        lp_buf[:, t] = token_lp
        token = next_token
    return buf, lp_buf


def encode_and_greedy_decode_t5(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    inputs_embeds: torch.Tensor,      # (B, L, D)
    attention_mask: torch.Tensor,     # (B, L)
    max_new_tokens: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder pass + greedy decode (the reference's
    ``lm.generate(inputs_embeds=...)``)."""
    encoder_hidden = t5_lib.t5_encode(params, cfg,
                                      inputs_embeds=inputs_embeds,
                                      attention_mask=attention_mask)
    return greedy_decode_t5(params, cfg, encoder_hidden, attention_mask,
                            max_new_tokens)


def chunked_prefill_greedy_decode_t5(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    inputs_embeds: torch.Tensor,      # (B, L, D)
    attention_mask: torch.Tensor,     # (B, L)
    max_new_tokens: int = 20,
    prefill_chunks: int = 2,
    force_eos_at: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode and build the cross-KV cache in ``prefill_chunks`` batch
    chunks, then decode at the full batch: the prefill's activation peak
    shrinks about chunks-fold while the decode runs as before.

    Each chunk's encoder states are projected straight into its rows of one
    preallocated (layers, B, ...) cross cache, so no chunk-stacked copy is
    merged afterwards. Equal to the unchunked path: the encoder and the
    per-row cross-KV quantization are row-independent, and the int8 layout
    is resolved from the full batch, as ``t5_decode_step`` resolves it."""
    batch = inputs_embeds.shape[0]
    if batch % prefill_chunks:
        raise ValueError(
            f"prefill_chunks={prefill_chunks} must divide batch={batch}")
    rows = batch // prefill_chunks
    shape = (cfg.num_decoder_layers, batch, max_new_tokens,
             t5_lib.self_cache_heads(params, cfg), cfg.d_kv)
    dev = inputs_embeds.device
    cache = {"self_k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "self_v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "index": 0}
    for start in range(0, batch, rows):
        chunk = slice(start, start + rows)
        hidden = t5_lib.t5_encode(params, cfg,
                                  inputs_embeds=inputs_embeds[chunk],
                                  attention_mask=attention_mask[chunk])
        t5_lib.cross_kv_cache(params, cfg, hidden, layout_batch=batch,
                              out=cache, row0=start)
        del hidden
    return greedy_decode_from_cache(params, cfg, cache, attention_mask,
                                    max_new_tokens, force_eos_at)


def forced_decode_t5(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    encoder_hidden: torch.Tensor,     # (B, L, D)
    encoder_mask: torch.Tensor,       # (B, L)
    decoder_input_ids: torch.Tensor,  # (B, T0) forced prefix (incl. start)
    max_new_tokens: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-force a decoder prefix one step a token, then continue
    greedily from the last forced step's logits (the reference's
    ``decoder_input_ids`` path). The cache holds T0 + max_new_tokens
    positions; only the new tokens are returned, as (tokens, log-probs)."""
    batch, forced_len = decoder_input_ids.shape
    dev = encoder_hidden.device
    cache = t5_lib.init_decode_cache(params, cfg, encoder_hidden,
                                     forced_len + max_new_tokens)
    forced = torch.as_tensor(decoder_input_ids, device=dev).to(torch.int32)
    # with no forced token, JAX's scan leaves its zero logits
    logits = torch.zeros((batch, cfg.vocab_size), dtype=torch.float32,
                         device=dev)
    for j in range(forced_len):
        logits, cache = t5_lib.t5_decode_step(params, cfg, forced[:, j],
                                              cache, encoder_mask)
    buf = torch.full((batch, max_new_tokens), cfg.pad_token_id,
                     dtype=torch.int32, device=dev)
    lp_buf = torch.zeros((batch, max_new_tokens), dtype=torch.float32,
                         device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    for t in range(max_new_tokens):
        if bool(finished.all()):
            break
        next_token, token_lp = _greedy_pick(logits, finished,
                                            cfg.pad_token_id)
        finished = finished | (next_token == cfg.eos_token_id)
        buf[:, t] = next_token
        lp_buf[:, t] = token_lp
        # the step's logits feed only the next iteration (JAX computes them
        # on the last one too, and drops them)
        if t + 1 < max_new_tokens and not bool(finished.all()):
            logits, cache = t5_lib.t5_decode_step(params, cfg, next_token,
                                                  cache, encoder_mask)
    return buf, lp_buf


def top_k_lowest_index_first(x: torch.Tensor, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of ``x`` and their indices, equal values
    in ascending index order (``jax.lax.top_k``'s rule; ``torch.topk``
    promises no order among ties): a stable descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_search_t5(
    params: Dict[str, Any],
    cfg: t5_lib.T5Config,
    encoder_hidden: torch.Tensor,     # (B, L, D)
    encoder_mask: torch.Tensor,       # (B, L)
    num_beams: int = 3,
    max_new_tokens: int = 20,
    length_penalty: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the KV-cached decoder (HF generate's
    ``num_beams``), with an all-beams-finished early exit.

    Beam 0 of each question starts live and the others at -1e9, so the
    first step gives K distinct continuations. A finished beam may emit
    only pad, at score 0. Each step takes the top K of the (B, K*V) totals
    (ties to the lower index, as ``lax.top_k``). A token's log-prob is its
    new score less its parent's, kept through every reorder, so
    ``sequence_scores`` ranks beam outputs as it ranks greedy ones. The
    pick is the argmax of score / max(len, 1) ** length_penalty. Returns
    (tokens (B, T) int32, token_logprobs (B, T) f32) of the winner."""
    batch = encoder_hidden.shape[0]
    K, V = num_beams, cfg.vocab_size
    rows = batch * K
    dev = encoder_hidden.device
    mask = encoder_mask.repeat_interleave(K, dim=0)
    # the cross cache of a question's K beams is its rows repeated (the
    # int8 layout resolved at B*K rows, as the decode step resolves it).
    # A beam's parent is always a beam of its own question, so reordering
    # these leaves would be the identity: only the self-attention K/V are
    # reordered below
    cache = {key: leaf.repeat_interleave(K, dim=1) for key, leaf in
             t5_lib.cross_kv_cache(params, cfg, encoder_hidden,
                                   layout_batch=rows).items()}
    shape = (cfg.num_decoder_layers, rows, max_new_tokens,
             t5_lib.self_cache_heads(params, cfg), cfg.d_kv)
    for key in ("self_k", "self_v"):
        cache[key] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    cache["index"] = 0
    # t5_decode_step writes a step's K/V into the cache in place, so each
    # reorder gathers into the other buffer of a pair
    spare = {key: torch.empty_like(cache[key])
             for key in ("self_k", "self_v")}

    token = torch.full((rows,), cfg.decoder_start_token_id,
                       dtype=torch.int32, device=dev)
    scores = torch.tensor([0.0] + [-1e9] * (K - 1), dtype=torch.float32,
                          device=dev).repeat(batch)
    finished = torch.zeros((rows,), dtype=torch.bool, device=dev)
    gen_len = torch.zeros((rows,), dtype=torch.int32, device=dev)
    buf = torch.zeros((rows, max_new_tokens), dtype=torch.int32, device=dev)
    lp_buf = torch.zeros((rows, max_new_tokens), dtype=torch.float32,
                         device=dev)
    pad_row = torch.full((V,), -1e9, dtype=torch.float32, device=dev)
    pad_row[cfg.pad_token_id] = 0.0
    question = torch.arange(batch, device=dev)[:, None] * K
    for t in range(max_new_tokens):
        if bool(finished.all()):
            break
        logits, cache = t5_lib.t5_decode_step(params, cfg, token, cache,
                                              mask)
        logp = torch.log_softmax(logits.float(), dim=-1)       # (B*K, V)
        logp = torch.where(finished[:, None], pad_row[None], logp)
        total = (scores[:, None] + logp).reshape(batch, K * V)
        top_scores, top_idx = top_k_lowest_index_first(total, K)
        flat_beam = (question + top_idx // V).reshape(-1)
        token = (top_idx % V).to(torch.int32).reshape(-1)
        was_finished = finished[flat_beam]
        finished = was_finished | (token == cfg.eos_token_id)
        gen_len = gen_len[flat_beam] + (~was_finished).to(torch.int32)
        new_scores = top_scores.reshape(-1)
        token_lp = new_scores - scores[flat_beam]
        scores = new_scores
        buf = buf[flat_beam]
        buf[:, t] = token
        lp_buf = lp_buf[flat_beam]
        lp_buf[:, t] = token_lp
        for key in ("self_k", "self_v"):
            torch.index_select(cache[key], 1, flat_beam, out=spare[key])
            cache[key], spare[key] = spare[key], cache[key]
    norm = scores / gen_len.clamp(min=1).to(torch.float32) ** length_penalty
    best = torch.argmax(norm.reshape(batch, K), dim=1)
    pick = torch.arange(batch, device=dev) * K + best
    return buf[pick], lp_buf[pick]


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
