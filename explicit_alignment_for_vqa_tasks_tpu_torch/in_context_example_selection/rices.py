"""RICES in-context example selection (Retrieval of In-Context ExampleS).

Counterpart of
explicit_alignment_for_vqa_tasks_tpu/in_context_example_selection/rices.py,
the reference's 4-stage FAISS pipeline (reference:
src/in_context_example_selection/*, run order per reference
README.md:151-158):

  1. question kNN: val questions -> top-2048 train questions by CLIP text
     embedding cosine (get_question_knn.py:65-83)
  2. reformat FAISS rows to train question ids
     (reformatting_faiss_output.py:17-25)
  3. image kNN within each question-kNN pool: val image vs the UNIQUE
     train images of its question neighbours
     (get_image_knn_from_text_knn.py:57-108)
  4. joint ranking: inner-join by img_key, joint = sim_img + sim_question,
     top-32 stored ASCENDING so the best example is LAST — consumed by
     ``[-num_shots:]`` slicing (get_average_similarities.py:46-71)

Stages 1 and 3 run on ``device`` (the card unless the caller passes
another) as true fp32 products with ``lax.top_k``'s tie order
(ops/knn.py), on one card or over a data mesh of processes (``mesh``,
the CLI's ``--mesh_data``: the databases' rows split over the ranks, the
results those of one card, rank 0 writing the pickle); 2 and 4 are the
JAX package's host code. Every pickle has the JAX package's schema, so the
files interoperate both ways.
"""

from __future__ import annotations

import logging
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, rank, resolve_device
from ..ops.knn import database_block, knn_search, l2_normalize, true_fp32
from ..parallel.mesh import MeshLike, resolve_mesh

logger = logging.getLogger(__name__)

TOP_K_QUESTIONS = 2048
TOP_K_EXAMPLES = 32


def _stack_embedding_dict(embeddings: Dict[str, np.ndarray]):
    keys = list(embeddings.keys())
    matrix = np.stack([np.asarray(embeddings[k]) for k in keys])
    return keys, matrix.reshape(len(keys), -1).astype(np.float32)


def question_knn(
    train_text_embeddings: Dict[str, np.ndarray],
    val_text_embeddings: Dict[str, np.ndarray],
    k: int = TOP_K_QUESTIONS,
    mesh: MeshLike = None,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Stages 1+2: cosine top-k of every val question over train questions.

    Returns the ``text_knns_reformatted.pkl`` schema:
    ``{str(val_qid): {"question_ids": [...], "similarities": (k,)}}``."""
    train_ids, train_matrix = _stack_embedding_dict(train_text_embeddings)
    val_ids, val_matrix = _stack_embedding_dict(val_text_embeddings)
    sims, idx = knn_search(val_matrix, train_matrix, k, mesh=mesh,
                           device=device)
    train_ids_arr = np.asarray(train_ids, dtype=object)
    return {
        str(val_ids[i]): {
            "question_ids": train_ids_arr[idx[i]].tolist(),
            "similarities": sims[i],
        }
        for i in range(len(val_ids))
    }


def image_knn_from_text_knn(
    text_knns: Dict[str, Dict],
    train_data_items: Sequence[Any],
    val_data_items: Sequence[Any],
    train_image_embeddings: Dict[str, np.ndarray],
    val_image_embeddings: Dict[str, np.ndarray],
    group_chunk: int = 1024,
    mesh: MeshLike = None,
    device: DeviceLike = None,
) -> Dict[Any, Dict]:
    """Stage 3: per val question, rank the UNIQUE train images of its
    question neighbours against the val image embedding.

    Returns the ``image_knns_reformatted.pkl`` schema:
    ``{val_qid: {"similarities": (1, C), "img_keys": [ordered desc]}}``.

    The JAX package's formulation (vs the reference's per-question FAISS
    index rebuild, get_image_knn_from_text_knn.py:57-95): the unique
    train-image matrix lives on the device once; per val chunk one product
    scores the val images against every train image, and a gather selects
    each neighbour pool's scores. Over a data ``mesh`` each rank holds a
    block of the image matrix's rows and scores the candidates it holds;
    the candidates' scores are summed over the ranks (one rank holds each,
    the others add zeros), so every rank gets one card's scores."""
    mesh = resolve_mesh(mesh)
    dev = resolve_device(device)
    # unique train image matrix + searchsorted qid -> image-index map
    img_keys: Dict[Any, int] = {}
    for item in train_data_items:
        img_keys.setdefault(item["img_key"], len(img_keys))
    key_list = list(img_keys)
    train_img_matrix = np.stack([
        np.asarray(train_image_embeddings[str(k)]).reshape(-1)
        for k in key_list
    ]).astype(np.float32)

    train_qids = np.asarray(
        [int(item["question_id"]) for item in train_data_items],
        dtype=np.int64,
    )
    train_img_idx = np.asarray(
        [img_keys[item["img_key"]] for item in train_data_items],
        dtype=np.int32,
    )
    qid_order = np.argsort(train_qids)
    qids_sorted = train_qids[qid_order]
    img_idx_sorted = train_img_idx[qid_order]

    # per-val neighbour image-index rows (variable k padded per chunk)
    val_qids, val_query_rows, neighbor_img_rows = [], [], []
    for item in val_data_items:
        qid = item["question_id"]
        neighbours = text_knns.get(str(qid))
        if neighbours is None:
            logger.warning("no question neighbours for %s", qid)
            continue
        val_emb = val_image_embeddings.get(str(item["img_key"]))
        if val_emb is None:
            logger.warning("no image embedding for %s", item["img_key"])
            continue
        nbr_qids = np.asarray(
            [int(q) for q in neighbours["question_ids"]], dtype=np.int64
        )
        pos = np.searchsorted(qids_sorted, nbr_qids)
        pos_c = np.clip(pos, 0, len(qids_sorted) - 1)
        if not np.array_equal(qids_sorted[pos_c], nbr_qids):
            missing = nbr_qids[qids_sorted[pos_c] != nbr_qids]
            raise KeyError(
                f"text_knns neighbour question_ids not present in the "
                f"train split (first few: {missing[:5].tolist()}) — "
                f"stale or mismatched pickles?"
            )
        neighbor_img_rows.append(img_idx_sorted[pos])
        val_query_rows.append(np.asarray(val_emb).reshape(-1))
        val_qids.append(qid)

    if not val_qids:
        return {}

    results: Dict[Any, Dict] = {}
    with true_fp32():
        if mesh is None:
            db = torch.as_tensor(train_img_matrix).to(dev)
        else:
            db, first = database_block(train_img_matrix, mesh, dev)
        db = l2_normalize(db)   # row by row: a block's rows as the whole's
        for start in range(0, len(val_qids), group_chunk):
            rows = neighbor_img_rows[start:start + group_chunk]
            width = max(len(r) for r in rows)
            cand = np.zeros((len(rows), width), dtype=np.int64)
            for i, r in enumerate(rows):
                cand[i, :len(r)] = r
                if len(r) < width:       # pad with the row's first candidate
                    cand[i, len(r):] = r[0] if len(r) else 0
            q = np.stack(val_query_rows[start:start + group_chunk]).astype(
                np.float32)
            scores = l2_normalize(torch.as_tensor(q).to(dev)) @ db.T
            cand_t = torch.as_tensor(cand).to(dev)
            if mesh is None:
                sims = scores.gather(1, cand_t)
            else:
                local = cand_t - first
                mine = (local >= 0) & (local < db.shape[0])
                sims = torch.where(mine, scores.gather(
                    1, local.clamp(0, db.shape[0] - 1)), 0.0)
                torch.distributed.all_reduce(sims, group=mesh.group)
            sims = sims.cpu().numpy()
            for i, r in enumerate(rows):
                n = len(r)
                row_sims = sims[i, :n]
                # unique by image (first occurrence), then descending by sim
                uniq_idx = np.sort(np.unique(r[:n], return_index=True)[1])
                u_imgs, u_sims = r[uniq_idx], row_sims[uniq_idx]
                order = np.argsort(-u_sims, kind="stable")
                results[val_qids[start + i]] = {
                    "similarities": u_sims[order][None, :],
                    "img_keys": [key_list[int(j)] for j in u_imgs[order]],
                }
    return results


def joint_ranking(
    image_nns: Dict[Any, Dict],
    question_nns: Dict[str, Dict],
    train_data_items: Sequence[Any],
    val_data_items: Sequence[Any],
    top_k: int = TOP_K_EXAMPLES,
    question_only: bool = False,
) -> Dict[str, List[Dict]]:
    """Stage 4: joint = sim_img + sim_question over the img_key inner
    join; top-32 stored ASCENDING (best example last). With
    ``question_only``, rank by question similarity alone
    (``rices_questions_only.pkl``)."""
    by_qid = {item["question_id"]: item for item in train_data_items}

    def img_key_of(train_qid) -> Any:
        return by_qid[int(train_qid)]["img_key"]

    rices: Dict[str, List[Dict]] = {}
    for item in val_data_items:
        qid = item["question_id"]
        q_nns = question_nns.get(str(qid))
        if q_nns is None:
            continue
        q_sims = np.asarray(q_nns["similarities"]).reshape(-1)
        rows: List[tuple] = []  # (joint_sim, img_key, train_qid)
        if question_only:
            for train_qid, sim in zip(q_nns["question_ids"], q_sims):
                rows.append((float(sim), img_key_of(train_qid), train_qid))
        else:
            i_nns = image_nns.get(qid)
            if i_nns is None:
                continue
            img_sims = {
                key: float(sim)
                for key, sim in zip(
                    i_nns["img_keys"],
                    np.asarray(i_nns["similarities"]).reshape(-1),
                )
            }
            for train_qid, q_sim in zip(q_nns["question_ids"], q_sims):
                key = img_key_of(train_qid)
                if key in img_sims:
                    rows.append(
                        (img_sims[key] + float(q_sim), key, train_qid)
                    )
        rows.sort(key=lambda r: r[0], reverse=True)
        rows = rows[:top_k]
        rows.reverse()  # ascending: best example LAST
        rices[str(qid)] = [
            {
                "question_id": train_qid,
                "img_key": img_key,
                "question": by_qid[int(train_qid)]["question"],
                "gold_answer": by_qid[int(train_qid)]["gold_answer"],
            }
            for _, img_key, train_qid in rows
        ]
    return rices


def random_examples(
    train_data_items: Sequence[Any],
    val_question_ids: Sequence[Any],
    num_examples: int = 16,
    seed: int = 2021,
) -> Dict[str, List[Dict]]:
    """RANDOM baseline (reference: src/utils/in_context_examples.py:286-304).
    Draws from numpy's global generator seeded with ``seed``, as the JAX
    package and the reference do, so that ``random.pkl`` is theirs."""
    np.random.seed(seed)
    by_qid = {item["question_id"]: item for item in train_data_items}
    qids = list(by_qid)
    out: Dict[str, List[Dict]] = {}
    for val_qid in val_question_ids:
        chosen = np.random.choice(len(qids), size=num_examples,
                                  replace=False)
        out[str(val_qid)] = [
            {
                "question_id": by_qid[qids[i]]["question_id"],
                "img_key": by_qid[qids[i]]["img_key"],
                "question": by_qid[qids[i]]["question"],
                "gold_answer": by_qid[qids[i]]["gold_answer"],
            }
            for i in chosen
        ]
    return out


def run_full_pipeline(
    train_text_embeddings_path: str,
    val_text_embeddings_path: str,
    train_image_embeddings_path: str,
    val_image_embeddings_path: str,
    train_data_items: Sequence[Any],
    val_data_items: Sequence[Any],
    out_path: str,
    question_only: bool = False,
    k_questions: int = TOP_K_QUESTIONS,
    mesh: MeshLike = None,
    device: DeviceLike = None,
) -> Dict[str, List[Dict]]:
    """All 4 stages end to end on ``device``, writing the rices pickle."""

    def load(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)

    logger.info("stage 1+2: question kNN")
    question_nns = question_knn(
        load(train_text_embeddings_path), load(val_text_embeddings_path),
        k=k_questions, mesh=mesh, device=device,
    )
    image_nns: Optional[Dict] = None
    if not question_only:
        logger.info("stage 3: image kNN within question pools")
        image_nns = image_knn_from_text_knn(
            question_nns, train_data_items, val_data_items,
            load(train_image_embeddings_path),
            load(val_image_embeddings_path),
            mesh=mesh, device=device,
        )
    logger.info("stage 4: joint ranking")
    rices = joint_ranking(
        image_nns or {}, question_nns, train_data_items, val_data_items,
        question_only=question_only,
    )
    if rank() == 0:  # one writer over a mesh of processes
        with open(out_path, "wb") as fh:
            pickle.dump(rices, fh)
        logger.info("wrote %d example lists to %s", len(rices), out_path)
    return rices
