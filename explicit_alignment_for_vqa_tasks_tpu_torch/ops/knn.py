"""Exact cosine / inner-product k-nearest-neighbour search on the card.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/knn.py, which
replaces FAISS ``IndexFlatIP`` over L2-normalized vectors (reference:
src/in_context_example_selection/get_question_knn.py:65-83 and
get_image_knn_from_text_knn.py:57-95). One fp32 product and a top-k give
the FAISS contract: (similarities, indices) as numpy arrays, sorted
descending.

Two rules the JAX package gets from XLA are explicit here:
  * the products are true fp32 whatever the caller's TF32 setting
    (``true_fp32``): a TF32 product moves scores by about 1e-3 of
    themselves and so changes which neighbours are chosen;
  * equal scores come in order of the lowest index, as ``lax.top_k`` puts
    them (``top_k_lowest_index``); ``torch.topk`` promises no order.

The JAX package pads the last query chunk and the candidate axis only to
spare XLA a recompile; the port has no compile, so it pads nothing.

Over a data mesh of processes (``parallel.mesh.make_data_mesh``, the tools'
``--mesh_data N``; JAX ``knn.py:36-88``) each rank holds a padded
contiguous block of the database rows on its card and takes its local
top-``k_local``; the candidates are gathered in (shard, local rank) order
(a host copy: gloo gathers no CUDA tensor) and merged by
``top_k_lowest_index``, so that the indices equal one card's, ties
included (a tie between shards goes to the lower shard, which holds the
lower rows).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import Mesh, MeshLike, resolve_mesh


@contextlib.contextmanager
def true_fp32() -> Iterator[None]:
    """cuBLAS fp32 matmuls without TF32 inside the block, the caller's
    setting restored after. The flag is ``allow_tf32``, the one the rest of
    the port reads: PyTorch refuses to read its matmul settings once the
    legacy and the newer ``fp32_precision`` API have both set them."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def top_k_lowest_index(scores: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest scores of each row of ``scores`` (..., N) and
    their indices, in descending order with equal scores by lowest index
    first (``lax.top_k``'s order).

    ``torch.topk`` picks the right set wherever fewer than k + 1 scores of
    the row reach its k-th: the set is then ordered by (-score, index).
    In a row where more do, which of the tied k-th scores it keeps is not
    promised, so that row is sorted whole by a stable descending sort."""
    vals, idx = torch.topk(scores, k, dim=-1, sorted=True)
    idx, perm = torch.sort(idx, dim=-1)
    vals = vals.gather(-1, perm)
    vals, perm = torch.sort(vals, dim=-1, descending=True, stable=True)
    idx = idx.gather(-1, perm)
    cut = (scores >= vals[..., -1:]).sum(dim=-1) > k
    if bool(cut.any()):
        rows = cut.nonzero(as_tuple=True)
        whole_vals, whole_idx = torch.sort(scores[rows], dim=-1,
                                           descending=True, stable=True)
        vals[rows] = whole_vals[..., :k]
        idx[rows] = whole_idx[..., :k]
    return vals, idx


def _as_f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=torch.float32)


def _to_numpy(sims: torch.Tensor, idx: torch.Tensor
              ) -> Tuple[np.ndarray, np.ndarray]:
    return sims.cpu().numpy(), idx.to(torch.int32).cpu().numpy()


def knn_search(
    queries,                   # (M, d) numpy or tensor
    database,                  # (N, d)
    k: int,
    normalize: bool = True,
    query_chunk: int = 1024,
    mesh: MeshLike = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (similarities (M, k) float32, indices (M, k) int32), sorted
    descending with ties by lowest index: the FAISS ``index.search``
    contract. Runs on ``device``, the card unless the caller passes
    another; over ``mesh`` (see ``resolve_mesh``) each rank searches its
    block of the database and every rank gets the whole result."""
    mesh = resolve_mesh(mesh)
    dev = resolve_device(device)
    n = database.shape[0]
    k = min(k, n)
    sims_out, idx_out = [], []
    with true_fp32():
        if mesh is None:
            db = _as_f32(database, dev)
        else:
            db, first = database_block(database, mesh, dev)
            k_local = min(k, db.shape[0])
        if normalize:           # row by row: a block's rows as the whole's
            db = l2_normalize(db)
        for start in range(0, queries.shape[0], query_chunk):
            q = _as_f32(queries[start:start + query_chunk], dev)
            if normalize:
                q = l2_normalize(q)
            if mesh is None:
                sims, idx = top_k_lowest_index(q @ db.T, k)
            else:
                sims, idx = _sharded_top_k(q, db, first, n, k, k_local, mesh)
            sims_out.append(sims)
            idx_out.append(idx)
    return _to_numpy(torch.cat(sims_out), torch.cat(idx_out))


def database_block(database, mesh: Mesh, dev: torch.device
                   ) -> Tuple[torch.Tensor, int]:
    """This rank's block of the database rows (numpy or tensor) as fp32 on
    ``dev``, padded to ceil(N / ways) rows with zeros, and the global index
    of its first row (JAX ``_shard_database``). The rows are sliced before
    they move, so a card holds its block and never the whole database."""
    ways, index = mesh.data_size, mesh.data_index
    rows = -(-database.shape[0] // ways)
    block = _as_f32(database[index * rows:(index + 1) * rows], dev)
    if block.shape[0] < rows:
        block = torch.cat([block, block.new_zeros(
            (rows - block.shape[0], block.shape[1]))])
    return block, index * rows


def _sharded_top_k(q: torch.Tensor, block: torch.Tensor, first: int,
                   n_valid: int, k: int, k_local: int, mesh: Mesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top ``k`` of ``q`` against the database whose rows
    ``first`` .. of ``block`` this rank holds: each rank's top-``k_local``
    (padded rows at -inf, global indices), gathered in rank order, merged
    by ``top_k_lowest_index`` over the candidates' positions."""
    from ..parallel.gather import all_gather_host

    scores = q @ block.T
    rows = torch.arange(first, first + block.shape[0], device=q.device)
    scores = torch.where(rows[None, :] < n_valid, scores, float("-inf"))
    sims, local = top_k_lowest_index(scores, k_local)
    cand_s = torch.cat(all_gather_host(sims, mesh.group), dim=1)
    cand_i = torch.cat(all_gather_host(local + first, mesh.group), dim=1)
    top, pos = top_k_lowest_index(cand_s, k)
    return top, cand_i.gather(1, pos)


def grouped_knn_search(
    queries,                   # (B, d) one query per group
    candidates,                # (B, C, d) per-group candidate vectors
    candidate_mask,            # (B, C) valid-candidate mask
    k: int,
    normalize: bool = True,
    batch_chunk: int = 256,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group exact top-k (the reference's per-question FAISS index
    rebuild, get_image_knn_from_text_knn.py:57-95); invalid slots score
    -inf. Not on the RICES path, which scores the whole image matrix once
    (in_context_example_selection/rices.py), as in the JAX package."""
    dev = resolve_device(device)
    k = min(k, candidates.shape[1])
    sims_out, idx_out = [], []
    with true_fp32():
        for start in range(0, queries.shape[0], batch_chunk):
            q = _as_f32(queries[start:start + batch_chunk], dev)
            c = _as_f32(candidates[start:start + batch_chunk], dev)
            m = torch.as_tensor(
                candidate_mask[start:start + batch_chunk]).to(dev, torch.bool)
            if normalize:
                q = l2_normalize(q)
                c = l2_normalize(c)
            scores = torch.matmul(c, q[:, :, None])[..., 0]
            scores = torch.where(m, scores, float("-inf"))
            sims, idx = top_k_lowest_index(scores, k)
            sims_out.append(sims)
            idx_out.append(idx)
    return _to_numpy(torch.cat(sims_out), torch.cat(idx_out))
