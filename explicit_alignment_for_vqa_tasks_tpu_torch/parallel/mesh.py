"""The (data, model) mesh over processes, and the tensor-parallel layout of
the frozen T5.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/parallel/mesh.py. The
JAX package builds one single-controller ``Mesh`` over devices; here a mesh
is a set of ranks, one process a rank (started by ``torchrun``, the group
built by ``parallel/multihost.py``), and each axis is the process groups
of its lines. The sizes come from ``config.tpu.mesh`` under JAX's rules
(``mesh_sizes``): ``data`` -1 or 0 is "the rest", ``model`` -1 or 0 is 1,
``dcn_data`` > 1 gives the hybrid ``(dcn_data, data, model)`` mesh, a
``pipe`` that the 2-D mesh cannot take folds into ``data``. Ranks are laid
out row-major in the axis order (data outer, model inner), so the ranks of
one model group are neighbours.

The batch shards over the data axes (``data_axes``): each data coordinate
reads its own rows and the ranks of one model group read the same ones.
Under ``model`` > 1 the T5 weights are split as Megatron splits them
(``t5_param_specs``): q, k, v, wi_0 and wi_1 by output column, o and wo by
input row, so that each attention and FFN block ends in one all-reduce over
the model group (``reduce_from_model``); at a block's input
``copy_to_model`` all-reduces the gradient. The int8 subtrees, the
embeddings and the relative-attention bias table stay whole.

A mesh is made active with ``with mesh:`` (or ``activate``); ``models/t5.py``
finds the model group of split weights there, and the loaders their data
coordinate.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import rank, world_size

logger = logging.getLogger(__name__)

# the int8 subtrees, kept whole on every rank (JAX mesh.py:195-203)
WHOLE_SUBTREES = ("ffn_q8", "self_attn_q8", "step_q8")
COLUMN_SPLIT = ("q", "k", "v", "wi_0", "wi_1")
ROW_SPLIT = ("o", "wo")

_ACTIVE: List["Mesh"] = []


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh: the axes' sizes (outer to inner), its
    coordinates on them, the global ranks of the mesh in its order, and
    the process groups it takes part in (None where an axis has one rank,
    or where the mesh is a layout only, built with no process group)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    ranks: Tuple[int, ...]
    member: bool = True
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_group: Any = None     # the data axes at this model coordinate
    group: Any = None          # every rank of the mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_size(self) -> int:
        return data_size(self)

    @property
    def data_index(self) -> int:
        """This rank's place over the data axes, outer to inner: the shard
        of the batch it reads."""
        index = 0
        for ax in data_axes(self):
            index = index * self.shape[ax] + self.coords[ax]
        return index

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` (or ``activate``)."""
    return _ACTIVE[-1] if _ACTIVE else None


def activate(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Make ``mesh`` the active one for the rest of the run (the previous
    ones dropped); None clears it."""
    _ACTIVE.clear()
    if mesh is not None:
        _ACTIVE.append(mesh)
    return mesh


def mesh_sizes(config: Optional[Any], world: int) -> Dict[str, int]:
    """The axes' sizes for ``world`` ranks from ``config.tpu.mesh``, by JAX
    ``make_mesh``'s rules (mesh.py:23-88), with its messages."""
    sizes: Dict[str, Any] = {"data": -1, "model": 1}
    if config is not None:
        sizes.update(dict(config.get("tpu", {}).get("mesh", {})))
    model = sizes.get("model", 1)
    if model in (-1, 0):
        model = 1
    data = sizes.get("data", -1)
    dcn_data = int(sizes.get("dcn_data", 1) or 1)
    pipe = int(sizes.get("pipe", 1) or 1)
    if dcn_data > 1:
        if pipe > 1:
            raise ValueError(
                "dcn_data composes with the 2-D (data, model) ICI mesh; "
                "pipe > 1 under DCN is not supported (the GPipe ppermute "
                "ring must stay on ICI)")
        if data in (-1, 0):
            data = (world // dcn_data) // model
        if dcn_data * data * model != world:
            raise ValueError(
                f"mesh sizes dcn_data={dcn_data} x data={data} x "
                f"model={model} != {world} devices")
        return {"dcn_data": dcn_data, "data": data, "model": model}
    if pipe > 1 and data not in (-1, 0) and data * pipe * model == world:
        logger.info("folding pipe=%d into data for the 2-D mesh", pipe)
        data = data * pipe
    if data in (-1, 0):
        data = world // model
    if data * model != world:
        raise ValueError(
            f"mesh sizes data={data} x model={model} != {world} devices")
    return {"data": data, "model": model}


def make_mesh(config: Optional[Any] = None,
              world: Union[None, int, Sequence[int]] = None) -> Mesh:
    """The mesh of ``config.tpu.mesh`` over ``world``: None for every rank
    of the process group (one without a group), an int n for ranks 0 .. n-1,
    or a sequence of global ranks (JAX's ``devices``). Where a process group
    is up, every one of its ranks must call this alike: it builds a group
    for each line of each axis of more than one rank, for the data axes at
    each model coordinate and for the whole mesh. A rank outside ``world``
    gets a mesh with ``member`` False. With no process group the mesh is a
    layout (rank 0's coordinates, no groups)."""
    up = dist.is_available() and dist.is_initialized()
    if world is None:
        ranks = tuple(range(dist.get_world_size() if up else 1))
    elif isinstance(world, int):
        ranks = tuple(range(world))
    else:
        ranks = tuple(int(r) for r in world)
    shape = mesh_sizes(config, len(ranks))
    me = dist.get_rank() if up else ranks[0]
    member = me in ranks
    layout = np.arange(len(ranks)).reshape(tuple(shape.values()))
    place = np.unravel_index(ranks.index(me), layout.shape) if member \
        else (0,) * len(shape)
    coords = {ax: int(c) for ax, c in zip(shape, place)}
    mesh = Mesh(shape=shape, coords=coords, ranks=ranks, member=member)
    if not up or len(ranks) == 1:
        return mesh

    def global_ranks(positions) -> List[int]:
        return [ranks[int(p)] for p in np.asarray(positions).reshape(-1)]

    axes = list(shape)
    for i, ax in enumerate(axes):
        if shape[ax] == 1:
            continue
        lines = np.moveaxis(layout, i, -1).reshape(-1, shape[ax])
        for line in lines:
            group = dist.new_group(global_ranks(line))
            if me in global_ranks(line):
                mesh.groups[ax] = group
    if data_size(mesh) > 1:
        by_model = np.moveaxis(layout, axes.index("model"), 0).reshape(
            shape["model"], -1)
        for line in by_model:
            group = dist.new_group(global_ranks(line))
            if me in global_ranks(line):
                mesh.data_group = group
    full = dist.get_world_size()
    mesh.group = None if len(ranks) == full else dist.new_group(list(ranks))
    logger.info("mesh %s over %d ranks: this rank at %s", shape, len(ranks),
                coords)
    return mesh


def make_data_mesh(data: int = -1,
                   world: Optional[int] = None) -> Optional[Mesh]:
    """The 1-D ``data`` mesh of the bulk tools' ``--mesh_data N``
    (JAX mesh.py:91-107): 0 or 1 no mesh, -1 every rank; wider than the
    world raises. Where JAX takes the first N of its devices, a process
    outside the mesh would have nothing to do: N must be the world."""
    if data in (0, 1):
        return None
    up = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if up else 1
    if data == -1:
        data = world
    if data > world:
        raise ValueError(f"--mesh_data {data} > {world} available devices")
    if data == 1:
        return None
    if data != world:
        raise ValueError(
            f"--mesh_data {data} of {world} processes: a data mesh spans "
            "every process (-1)")
    return make_mesh({"tpu": {"mesh": {"data": data, "model": 1}}}, data)


MeshLike = Union[None, int, Mesh]


def resolve_mesh(mesh: MeshLike) -> Optional[Mesh]:
    """A tool's data mesh, or None for one card: ``mesh`` is a ``Mesh`` or
    the tools' ``--mesh_data`` width (``make_data_mesh``'s rules)."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh if mesh is None or mesh.data_size > 1 else None
    return make_data_mesh(int(mesh))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the batch shards over (outer-to-inner)."""
    return ("dcn_data", "data") if "dcn_data" in mesh.shape else ("data",)


def data_size(mesh: Mesh) -> int:
    """Total data-parallel ways (product over the batch-sharding axes)."""
    size = 1
    for ax in data_axes(mesh):
        size *= mesh.shape[ax]
    return size


def data_shard(mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(this rank's data coordinate, the data ways) of ``mesh`` (the active
    one by default); where there is no mesh, (rank, processes) of the
    process group or of the launcher's environment, (0, 1) in one
    process."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is not None:
        return mesh.data_index, mesh.data_size
    return rank(), world_size()


def refuse_pipeline(config: Any) -> None:
    """Raise where ``config`` asks for the pipelined (data, pipe, model)
    mesh over several processes: its GPipe loss and the ``_pp`` generate
    twins are not ported (one process ignores ``tpu.mesh.pipe``, as the
    JAX package does on one device)."""
    tpu = config.get("tpu", {})
    pipe = int(tpu.get("mesh", {}).get("pipe", 1) or 1)
    if pipe > 1 and tpu.get("use_mesh", True) and world_size() > 1:
        raise NotImplementedError(
            f"tpu.mesh.pipe={pipe}: the pipelined (data, pipe, model) mesh, "
            "its GPipe loss and the _pp generate twins are not ported yet "
            "(ROADMAP.md, Queue 1 item 14, the pipeline); set "
            "tpu.mesh.pipe=1 for the (data, model) mesh")


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This data coordinate's rows of a global batch: the leading axis of
    each array or tensor leaf split into ``data_size`` contiguous blocks
    (JAX's ``P(data)`` placement); other leaves pass through."""
    ways, index = mesh.data_size, mesh.data_index

    def take(x):
        if (isinstance(x, np.ndarray) or torch.is_tensor(x)) and x.ndim >= 1:
            if x.shape[0] % ways:
                raise ValueError(
                    f"a batch of {x.shape[0]} rows does not split over "
                    f"{ways} data ways")
            rows = x.shape[0] // ways
            return x[index * rows:(index + 1) * rows]
        return x

    return {k: take(v) for k, v in batch.items()}


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensors(tree[key])]
    return [tree] if torch.is_tensor(tree) else []


def replicate_params(mesh: Optional[Mesh], params: Any) -> Any:
    """Every tensor of ``params`` broadcast from the mesh's first rank, in
    place, so that every rank holds the same value (JAX's invariant,
    mesh.py:155-178). The identity with no mesh."""
    if mesh is None or len(mesh.ranks) == 1 or not dist.is_initialized():
        return params
    with torch.no_grad():
        for tensor in _tensors(params):
            dist.broadcast(tensor.data, src=mesh.ranks[0], group=mesh.group)
    return params


def t5_param_specs(params: Any) -> Any:
    """For each leaf of a T5 tree, the axis split over ``model`` as a
    ``PartitionSpec``-like tuple (None for a whole axis), or ``()`` for a
    whole leaf (JAX mesh.py:181-210)."""

    def spec(names: Tuple[str, ...], leaf: Any) -> Tuple:
        if any(n in WHOLE_SUBTREES for n in names):
            return ()
        key = names[-1]
        stacked = leaf.ndim == 3
        if key in COLUMN_SPLIT:
            return (None, None, "model") if stacked else (None, "model")
        if key in ROW_SPLIT:
            return (None, "model", None) if stacked else ("model", None)
        return ()

    def walk(tree: Any, names: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, names + (k,)) for k, v in tree.items()}
        return spec(names, tree)

    return walk(params, ())


def shard_lm_params(mesh: Mesh, params: Any) -> Any:
    """This model rank's shard of the whole T5 tree ``params`` under
    ``t5_param_specs``: each split leaf's ``model_rank``-th of
    ``model_size`` contiguous blocks along its split axis, as its own
    tensor; whole leaves are the same tensors. A new dict; ``params`` is
    not changed."""
    specs = t5_param_specs(params)
    ways, index = mesh.model_size, mesh.model_rank

    def walk(tree: Any, spec: Any) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if ways == 1 or "model" not in spec:
            return tree
        axis = spec.index("model")
        if tree.shape[axis] % ways:
            raise ValueError(
                f"a weight of {tuple(tree.shape)} does not split over "
                f"{ways} model ways on axis {axis}")
        return tree.chunk(ways, dim=axis)[index].contiguous()

    return walk(params, specs)


# ---------------------------------------------------------------------------
# The model axis's collectives (Megatron's conjugate pair)
# ---------------------------------------------------------------------------

def _all_reduce_f32(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over ``group``, reduced in fp32 (gloo reduces no
    bf16 on every build), in ``x``'s dtype; ``x`` is not changed."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """At a block's input: the identity forward, the all-reduce of the
    gradient backward (each model rank's gradient of the replicated input
    covers its own heads or columns only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """At a block's output: the all-reduce of the partial products forward,
    the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.model_size == 1:
        return x
    return _CopyToModel.apply(x, mesh.groups.get("model"))


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.model_size == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.groups.get("model"))


def split_by_model(local: int, whole: int) -> Optional[Mesh]:
    """The active mesh where a width of ``whole`` (heads, FFN columns)
    arrives as ``local`` on this rank; None where it is whole. Raises where
    no active mesh splits it so."""
    if local == whole:
        return None
    mesh = active_mesh()
    if mesh is None or mesh.model_size * local != whole:
        raise ValueError(
            f"a weight of {local} of {whole} heads or columns, but the "
            f"active mesh {None if mesh is None else mesh.shape} does not "
            "split the model axis so: run under the mesh that "
            "shard_lm_params split it over")
    return mesh


def gather_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """``x`` of every model rank joined along ``dim`` in model-rank order
    (a host copy: gloo gathers no CUDA tensor)."""
    from .gather import all_gather_host

    return torch.cat(all_gather_host(x, mesh.groups.get("model")), dim=dim)


def data_sum(value: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``value`` summed over the data axes (a new tensor; ``value`` with no
    mesh or one data way)."""
    if mesh is None or mesh.data_group is None:
        return value
    return _all_reduce_f32(value, mesh.data_group)


def sum_grads_over_data(mesh: Optional[Mesh],
                        tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor's ``grad`` replaced by its sum over the data axes: one
    all-reduce of the gradients flattened together, in fp32."""
    if mesh is None or mesh.data_group is None:
        return
    grads = [t.grad for t in tensors]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    offset = 0
    for t, g in zip(tensors, grads):
        n = g.numel()
        t.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n


def data_max(value: int, mesh: Optional[Mesh]) -> int:
    """The largest ``value`` over the data axes (``value`` itself with no
    mesh or one data way)."""
    if mesh is None or mesh.data_group is None:
        return value
    host = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(host, op=dist.ReduceOp.MAX, group=mesh.data_group)
    return int(host.item())
