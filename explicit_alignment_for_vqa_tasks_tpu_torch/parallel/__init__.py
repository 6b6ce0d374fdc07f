"""Multi-process runs over ``torch.distributed``: the process group and its
backend, the (data, model) mesh of ranks with the tensor-parallel layout of
the T5, and the exchanges between the processes."""

from .gather import (
    all_gather_host,
    gather_predictions_to_host0,
    max_across_processes,
    metric_psum,
)
from .mesh import (
    Mesh,
    active_mesh,
    activate,
    data_axes,
    data_shard,
    data_size,
    make_data_mesh,
    make_mesh,
    replicate_params,
    shard_batch,
    shard_lm_params,
    t5_param_specs,
)
from .multihost import backend, choose_backend, maybe_initialize_distributed

__all__ = [
    "Mesh",
    "activate",
    "active_mesh",
    "all_gather_host",
    "backend",
    "choose_backend",
    "data_axes",
    "data_shard",
    "data_size",
    "gather_predictions_to_host0",
    "make_data_mesh",
    "make_mesh",
    "max_across_processes",
    "maybe_initialize_distributed",
    "metric_psum",
    "replicate_params",
    "shard_batch",
    "shard_lm_params",
    "t5_param_specs",
]
