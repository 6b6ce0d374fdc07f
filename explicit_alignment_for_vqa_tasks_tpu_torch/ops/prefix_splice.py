"""Sentinel prefix splicing — the core "explicit alignment" op.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/prefix_splice.py.
Each T5 sentinel ``<extra_id_i>`` (id ``base - i``) in a prompt is replaced
by ``prefix_length`` visual-prefix embedding slots:

  * output length is static: ``L + (prefix_length - 1) * num_prefixes``;
  * the j-th sentinel met left to right receives ``prefix_embeds[:, j]``;
  * prefix slots get attention mask 1; text slots keep their mask;
  * positions that fall past the output are dropped, and slots that no
    input reaches stay zero with mask 0.

The splice is a gather: small integer maps say, for each output slot,
which text row or which prefix row fills it, so no (B, L, n, D) tensor is
built.
"""

from __future__ import annotations

import torch

T5_SENTINEL_BASE = 32099  # id of <extra_id_0>


def splice_output_length(
    input_length: int, prefix_length: int, num_prefixes: int
) -> int:
    """Static output length of insert_prefix_into_input."""
    return input_length + (prefix_length - 1) * num_prefixes


def insert_prefix_into_input(
    tokens: torch.Tensor,          # (B, L) int — prompt token ids
    text_embeds: torch.Tensor,     # (B, L, D) — embedded prompt tokens
    prefix_embeds: torch.Tensor,   # (B, num_prefixes, prefix_length, D)
    attention_mask: torch.Tensor,  # (B, L) int
    *,
    prefix_length: int,
    num_prefixes: int,
    base_id: int = T5_SENTINEL_BASE,
):
    """Returns (joint_embeds (B, L_out, D), joint_mask (B, L_out)) with
    L_out = L + (prefix_length - 1) * num_prefixes."""
    batch, length, dim = text_embeds.shape
    n = prefix_length
    out_len = splice_output_length(length, n, num_prefixes)
    dev = tokens.device

    is_sentinel = (tokens <= base_id) & (tokens > base_id - num_prefixes)
    count = is_sentinel.to(torch.int64)
    sent_before = torch.cumsum(count, dim=1) - count  # strictly before
    # out position of text token j: j + (n-1) * (#sentinels before j); a
    # sentinel's gap of n slots starts at the same expression
    positions = torch.arange(length, device=dev)[None, :] + (n - 1) * sent_before
    rows = torch.arange(batch, device=dev)[:, None]

    # slot out_len is the drop slot for sentinels and overflow
    text_pos = torch.where(is_sentinel, out_len, positions).clamp(max=out_len)
    text_src = torch.full((batch, out_len + 1), -1, dtype=torch.int64, device=dev)
    text_src[rows, text_pos] = torch.arange(length, device=dev).expand(batch, -1)

    offsets = torch.arange(n, device=dev)[None, None, :]
    gap_pos = torch.where(
        is_sentinel[:, :, None], positions[:, :, None] + offsets, out_len
    ).clamp(max=out_len)                                          # (B, L, n)
    gap = sent_before.clamp(0, num_prefixes - 1)[:, :, None] * n + offsets
    prefix_src = torch.full((batch, out_len + 1), -1, dtype=torch.int64,
                            device=dev)
    prefix_src[rows[:, :, None], gap_pos] = gap
    text_src, prefix_src = text_src[:, :out_len], prefix_src[:, :out_len]

    def take(values, src):  # values (B, N, D) at src (B, out_len) >= 0
        idx = src.clamp(min=0)[:, :, None].expand(-1, -1, dim)
        return torch.gather(values, 1, idx)

    flat_prefix = prefix_embeds.reshape(batch, num_prefixes * n, dim)
    zero = torch.zeros((), dtype=text_embeds.dtype, device=dev)
    # the prefix is written after the text in the reference scatter, so a
    # prefix slot wins a collision
    joint = torch.where(
        (prefix_src >= 0)[:, :, None],
        take(flat_prefix.to(text_embeds.dtype), prefix_src),
        torch.where((text_src >= 0)[:, :, None], take(text_embeds, text_src),
                    zero),
    )
    text_mask = torch.gather(attention_mask, 1, text_src.clamp(min=0))
    joint_mask = torch.where(
        prefix_src >= 0, torch.ones_like(text_mask),
        torch.where(text_src >= 0, text_mask, torch.zeros_like(text_mask)),
    )
    return joint, joint_mask
