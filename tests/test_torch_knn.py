"""The port's exact kNN (ops/knn.py) against the JAX package's on the CPU:
knn_search and grouped_knn_search give JAX's indices and its similarities
within 1e-6, on random vectors, planted ties and k larger than N; the tie
rule is lax.top_k's (equal scores by lowest index), and the products are
true fp32 whatever the global TF32 setting."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu.ops import knn as jknn  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import knn as tknn  # noqa: E402

SIM_TOL = 1e-6


def assert_equal_to_jax(got, want):
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == ws.dtype == np.float32
    assert gi.dtype == wi.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SIM_TOL)


def lowest_index_first(scores, k):
    """The reference order: descending score, then ascending index."""
    order = np.lexsort((np.broadcast_to(np.arange(scores.shape[-1]),
                                        scores.shape), -scores), axis=-1)
    return order[..., :k]


# (M, N, d, k, query_chunk): chunks that do not divide M, k of one, k = N
# and k larger than N (clamped to N, as in JAX)
SEARCH_CASES = [(37, 200, 32, 5, 16), (5, 16, 8, 16, 1024), (3, 4, 8, 10, 2),
                (64, 300, 24, 1, 64), (9, 129, 16, 33, 4)]


@pytest.mark.parametrize("m,n,d,k,chunk", SEARCH_CASES)
def test_knn_search_matches_jax(m, n, d, k, chunk):
    rng = np.random.default_rng(m * n + d)
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    want = jknn.knn_search(q, db, k=k, query_chunk=chunk)
    got = tknn.knn_search(q, db, k=k, query_chunk=chunk, device="cpu")
    assert got[0].shape == (m, min(k, n))
    assert_equal_to_jax(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_knn_search_ties_take_the_lowest_index(normalize):
    """Rows repeated across the database (JAX's mesh tie test) and
    integer-valued vectors (exact products in any order) with k cutting
    through a band of equal scores: JAX's order, the lowest index first."""
    rng = np.random.default_rng(5)
    if normalize:
        base = rng.standard_normal((6, 8)).astype(np.float32)
        db = np.concatenate([base, base, base, base])
        q = base[:3]
    else:
        db = rng.integers(-2, 3, (60, 6)).astype(np.float32)
        db[40:] = db[:20]
        q = rng.integers(-2, 3, (7, 6)).astype(np.float32)
    for k in (3, 8, 21):
        want = jknn.knn_search(q, db, k=k, normalize=normalize)
        got = tknn.knn_search(q, db, k=k, normalize=normalize, device="cpu")
        assert_equal_to_jax(got, want)
        if not normalize:
            np.testing.assert_array_equal(
                got[1], lowest_index_first(q @ db.T, k))


def test_top_k_lowest_index_on_heavy_ties():
    """Whole rows equal, -inf bands and a band the k-th score cuts."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 3, (6, 50)).astype(np.float32)
    scores[0] = 1.0
    scores[1, :45] = -np.inf
    scores[2] = -np.inf
    for k in (1, 4, 17, 50):
        vals, idx = tknn.top_k_lowest_index(torch.from_numpy(scores), k)
        want = lowest_index_first(scores, k)
        np.testing.assert_array_equal(idx.numpy(), want)
        np.testing.assert_array_equal(
            vals.numpy(), np.take_along_axis(scores, want, axis=-1))


def test_knn_search_is_true_fp32_whatever_the_global_setting(monkeypatch):
    """The products run with TF32 off inside the call, the caller's
    setting restored after, and the results equal those under the
    default setting."""
    rng = np.random.default_rng(9)
    db = rng.standard_normal((120, 16)).astype(np.float32)
    q = rng.standard_normal((10, 16)).astype(np.float32)
    want = tknn.knn_search(q, db, k=7, device="cpu")
    seen = []
    top_k = tknn.top_k_lowest_index

    def recording(scores, k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return top_k(scores, k)

    monkeypatch.setattr(tknn, "top_k_lowest_index", recording)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = tknn.knn_search(q, db, k=7, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert seen == [False]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("k", [3, 10, 16])
def test_grouped_knn_search_matches_jax(k):
    """Masked slots score -inf; k above the candidates' count is clamped;
    JAX pads the candidate axis to a power of two, the port does not."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((7, 8)).astype(np.float32)
    c = rng.standard_normal((7, 10, 8)).astype(np.float32)
    c[3, 5:] = c[3, :5]                 # planted ties within one group
    mask = np.ones((7, 10), dtype=bool)
    mask[0, 5:] = False
    mask[2, :] = False                  # a group with no valid candidate
    want = jknn.grouped_knn_search(q, c, mask, k=k, batch_chunk=3)
    got = tknn.grouped_knn_search(q, c, mask, k=k, batch_chunk=3,
                                  device="cpu")
    assert got[0].shape == (7, min(k, 10))
    assert_equal_to_jax(got, want)
    assert np.all(np.isneginf(got[0][2]))


def test_mesh_and_missing_card_are_refused(monkeypatch):
    db = np.eye(4, dtype=np.float32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tknn.knn_search(db, db, k=2, mesh=2, device="cpu")
    tknn.knn_search(db, db, k=2, mesh=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tknn.knn_search(db, db, k=2)

