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
spare XLA a recompile; the port has no compile, so it pads nothing. Its
multi-chip search over a mesh is ROADMAP.md, Queue 1 item 14: ``mesh``
other than None, 0 or 1 raises.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def check_single_card(mesh: Optional[int]) -> None:
    """``mesh`` is the width of a data mesh (the JAX tools' ``--mesh_data``:
    0 or 1 no mesh, -1 every device); the port searches on one card."""
    if mesh is not None and mesh not in (0, 1):
        raise NotImplementedError(
            f"a kNN mesh of {mesh} cards is not ported yet (ROADMAP.md, "
            "Queue 1 item 14); use one card")


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
    mesh: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (similarities (M, k) float32, indices (M, k) int32), sorted
    descending with ties by lowest index: the FAISS ``index.search``
    contract. Runs on ``device``, the card unless the caller passes
    another."""
    check_single_card(mesh)
    dev = resolve_device(device)
    k = min(k, database.shape[0])
    sims_out, idx_out = [], []
    with true_fp32():
        db = _as_f32(database, dev)
        if normalize:
            db = l2_normalize(db)
        for start in range(0, queries.shape[0], query_chunk):
            q = _as_f32(queries[start:start + query_chunk], dev)
            if normalize:
                q = l2_normalize(q)
            sims, idx = top_k_lowest_index(q @ db.T, k)
            sims_out.append(sims)
            idx_out.append(idx)
    return _to_numpy(torch.cat(sims_out), torch.cat(idx_out))


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
