"""Mapping networks: CLIP embedding -> visual prefix in LM embedding space.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/mappers.py,
restricted to the MLP mapper (prefix_size -> (d*n)/2 -> d*n, tanh) that the
shipped few-shot configs use. It runs in fp32; the caller casts to the LM's
dtype at the splice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static mapper hyperparameters (the JAX package's field set)."""

    mapping_type: str = "mlp"          # "mlp" | "transformer" | "perceiver"
    prefix_size: int = 768             # CLIP embedding dim
    d_model: int = 2048                # LM embedding dim
    prefix_length: int = 10
    clip_length: int = 10
    num_layers: int = 8
    num_heads: int = 8
    dim_head: int = 64


def _not_ported(cfg: MapperConfig) -> None:
    if cfg.mapping_type in ("transformer", "perceiver"):
        raise NotImplementedError(
            f"the {cfg.mapping_type} mapper is not ported yet "
            "(ROADMAP.md, Queue 1 item 3)")


def _linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    bound = (1.0 / in_dim) ** 0.5

    def uniform(shape):
        u = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return u.mul_(2 * bound).sub_(bound)

    return {"w": uniform((in_dim, out_dim)), "b": uniform((out_dim,))}


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def init_mlp_mapper(gen: torch.Generator, prefix_size: int, d_model: int,
                    prefix_length: int) -> Params:
    hidden = (d_model * prefix_length) // 2
    out = d_model * prefix_length
    return {
        "fc1": _linear_init(gen, prefix_size, hidden),
        "fc2": _linear_init(gen, hidden, out),
    }


def mlp_mapper_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., prefix_size) -> (..., prefix_length * d_model)."""
    return _linear(params["fc2"], torch.tanh(_linear(params["fc1"], x)))


def init_mapper(gen: torch.Generator, cfg: MapperConfig) -> Params:
    """fp32 mapper params on ``gen``'s device, uniform in +-fan_in^-1/2
    like the JAX init. (The reference falls back to the MLP for unknown
    types.)"""
    _not_ported(cfg)
    return init_mlp_mapper(gen, cfg.prefix_size, cfg.d_model,
                           cfg.prefix_length)


def mapper_apply(cfg: MapperConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """(..., prefix_size) -> (..., prefix_length * d_model)."""
    _not_ported(cfg)
    return mlp_mapper_apply(params, x)
