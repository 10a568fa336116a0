"""The port's dense and PQ indexes, hit@k and ranking metrics against the
JAX package's (CPU).

Exact, fast and approx search, chunked and not, on corpora with duplicated
rows where ties decide the ids; rerank; persistence and the errors; the
k-means, the encoder and the codes bitwise; PQ search, uint16 codes; and the
copied metrics on the same inputs.
"""

import numpy as np
import pytest
import torch

from lako_tpu.retrieval import pq as jax_pq
from lako_tpu.retrieval.eval import answer_bearing_first as jax_answer_bearing_first
from lako_tpu.retrieval.eval import hit_at_k as jax_hit_at_k
from lako_tpu.retrieval.index import DenseIndex as JaxDenseIndex
from lako_tpu.retrieval.index import add_facts_to_examples as jax_add_facts
from lako_tpu.text.metrics import count_inversions as jax_count_inversions
from lako_tpu.text.metrics import ranking_stats as jax_ranking_stats
from lako_tpu_torch.retrieval import pq
from lako_tpu_torch.retrieval.eval import answer_bearing_first, hit_at_k
from lako_tpu_torch.retrieval.index import (
    DenseIndex,
    ShardedDenseIndex,
    add_facts_to_examples,
    decode_keys,
    tie_keys,
)
from lako_tpu_torch.text.metrics import count_inversions, ranking_stats
from tests.fixtures import make_examples

CPU = dict(device="cpu")


def _tied_corpus(n=3000, d=16, seed=0):
    """A corpus of small integers, so that every score is an integer that
    any summation order computes exactly: equal scores are exact ties on
    every BLAS and device, and they are many. One row is copied 40 times
    across the corpus and others once, and queries include the copied rows,
    so the k-th boundary falls inside groups of equal scores."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    group = rng.choice(np.arange(1, n), size=40, replace=False)
    emb[group] = emb[0]
    rest = np.setdiff1d(np.arange(1, n), group)
    pairs = rng.choice(rest, size=(n // 15, 2), replace=False)
    emb[pairs[:, 1]] = emb[pairs[:, 0]]
    q = rng.integers(-4, 5, size=(12, d)).astype(np.float32)
    q[0] = emb[0] * 2.0
    q[1] = emb[pairs[0, 0]]
    q[2] = -emb[0]
    return emb, q


@pytest.mark.parametrize("method", ["exact", "fast", "approx"])
@pytest.mark.parametrize("chunk_size", [131072, 1000, 17])
@pytest.mark.parametrize("k", [1, 25, 60])
def test_dense_search_matches_jax_with_ties(method, chunk_size, k):
    """Ids equal (ties lowest row first, at the k-th boundary too), scores
    rtol 1e-6, for every method (all float32 on the CPU), with and without
    chunks. At k=1 XLA:CPU's approx_max_k fallback takes the last of tied
    maxima; the port's "approx" keeps lax.top_k's order (ROADMAP §3), so
    there its ids are the JAX exact search's and differ from the JAX approx
    search's only where the scores tie. approx_max_k takes no k above the
    chunk, where the port's "approx" is held to the JAX exact search."""
    emb, q = _tied_corpus()
    ids = np.arange(5000, 5000 + len(emb), dtype=np.int64)
    jmethod = "exact" if method == "approx" and chunk_size < k else method
    want_ids, want = JaxDenseIndex(emb, ids, chunk_size=chunk_size, method=jmethod).search(q, k)
    got_ids, got = DenseIndex(emb, ids, chunk_size=chunk_size, method=method, **CPU).search(q, k)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if method == "approx" and k == 1:
        differ = got_ids != want_ids
        assert (got[differ] == want[differ]).all()
        want_ids = JaxDenseIndex(emb, ids, chunk_size=chunk_size).search(q, k)[0]
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got.dtype == np.float32 and got_ids.dtype == np.int64
    if k == 25:
        # query 0 is the 41-row group at 2x: the 25 lowest rows of it, in order
        group = np.flatnonzero((emb == emb[0]).all(1))
        np.testing.assert_array_equal(got_ids[0] - 5000, group[:25])


def test_search_batches_and_tie_keys():
    """Query batches do not change the result; the int64 keys order score
    descending then row ascending, -0.0 below +0.0 as lax.top_k orders it,
    and decode back to the scores and rows bitwise."""
    emb, q = _tied_corpus(seed=3)
    index = DenseIndex(emb, chunk_size=512, **CPU)
    a = index.search(q, 30)
    b = index.search(q, 30, batch_size=5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    scores = torch.tensor([[1.5, -0.0, 0.0, -2.0, 1.5, np.float32(-3e38), 7.0, -0.0]])
    keys = tie_keys(scores, 10)
    order = keys.topk(8, dim=1).values
    s, rows = decode_keys(order)
    assert rows.tolist() == [[16, 10, 14, 12, 11, 17, 13, 15]]
    assert torch.equal(s.view(torch.int32), scores[0, (rows[0] - 10)].view(torch.int32)[None])


def test_rerank_matches_jax():
    """Positional and non-positional ids, ties kept in candidate order
    (a stable sort), scores rtol 1e-6, and the batched call equal to one."""
    emb, q = _tied_corpus(n=400, seed=4)
    group = np.flatnonzero((emb == emb[0]).all(1))
    rng = np.random.default_rng(5)
    cand = np.stack([rng.permutation(400)[:50] for _ in range(len(q))])
    cand[0, 10:20] = group[:10][::-1]
    for ids in (None, np.arange(100, 500, dtype=np.int64)):
        c = cand if ids is None else ids[cand]
        want = JaxDenseIndex(emb, ids).rerank(c, q)
        got = DenseIndex(emb, ids, **CPU).rerank(c, q)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        batched = DenseIndex(emb, ids, **CPU).rerank(c, q, batch_size=5)
        np.testing.assert_array_equal(batched[0], got[0])
    with pytest.raises(KeyError, match="not present"):
        DenseIndex(emb, np.arange(100, 500), **CPU).rerank(np.array([[7]]), q[:1])


def test_save_load_errors_and_add_facts(tmp_path, monkeypatch):
    emb, q = _tied_corpus(n=300, seed=6)
    ids = np.arange(300)[::-1].copy()
    DenseIndex(emb, ids, **CPU).save(str(tmp_path / "ix"))
    JaxDenseIndex(emb, ids).save(str(tmp_path / "jx"))
    for name in ("embeddings.npy", "ids.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "ix" / name),
                                      np.load(tmp_path / "jx" / name))
    assert (tmp_path / "ix" / "meta.json").read_text() == (tmp_path / "jx" / "meta.json").read_text()
    loaded = DenseIndex.load(str(tmp_path / "jx"), method="fast", **CPU)
    np.testing.assert_array_equal(loaded.search(q, 9)[0],
                                  JaxDenseIndex.load(str(tmp_path / "ix")).search(q, 9)[0])
    bad = emb.copy()
    bad[2, 3] = np.nan
    with pytest.raises(FloatingPointError):
        DenseIndex(bad, **CPU)
    with pytest.raises(ValueError, match="exceeds the corpus size"):
        DenseIndex(emb, **CPU).search(q, 301)
    with pytest.raises(ValueError, match="k must be >= 1"):
        DenseIndex(emb, **CPU).search(q, 0)
    with pytest.raises(ValueError, match="exact|fast|approx"):
        DenseIndex(emb, method="fuzzy", **CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        ShardedDenseIndex(emb, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseIndex(emb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pq.PQIndex(np.zeros((2, 4, 4), np.float32), np.zeros((3, 2), np.uint8))
    examples = make_examples(2, n_facts=2)
    jexamples = make_examples(2, n_facts=2)
    sentences = {i: f"fact {i}" for i in range(300)}
    found = DenseIndex(emb, ids, **CPU).search(q[:2], 3)
    add_facts_to_examples(examples, *found, sentences)
    jax_add_facts(jexamples, *found, sentences)
    assert examples == jexamples


def test_kmeans_and_encode_bitwise():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(900, 4)).astype(np.float32)
    for k, seed in ((16, 0), (1000, 3)):
        np.testing.assert_array_equal(pq._kmeans(x, k, 5, seed), jax_pq._kmeans(x, k, 5, seed))
    books = np.stack([jax_pq._kmeans(x[:, 2 * j:2 * j + 2], 64, 3, j) for j in range(2)])
    got = pq.PQIndex._encode(x, books, row_batch=128)
    want = jax_pq.PQIndex._encode(x, books, row_batch=128)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_bits,chunk_size", [(8, 65536), (8, 333), (9, 256)])
def test_pq_matches_jax(tmp_path, n_bits, chunk_size):
    """Codebooks and codes bitwise; ids equal and scores within rtol 1e-6
    of the JAX search (scores ~230: a float32 ulp is 1.5e-5) and atol 1e-4
    of the reconstruction's inner products, as the JAX test holds them; uint16 codes for
    n_bits > 8 kept exactly on the device (as int16 bits); save and load."""
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(16, 32)) * 3
    emb = (centers[rng.integers(0, 16, 2000)]
           + rng.normal(size=(2000, 32)) * 0.3).astype(np.float32)
    emb[1500] = emb[3]
    q = (centers[rng.integers(0, 16, 8)] + rng.normal(size=(8, 32)) * 0.3).astype(np.float32)
    kw = dict(n_subquantizers=16 if n_bits == 8 else 4, n_bits=n_bits, train_size=1000, iters=4)
    jindex = jax_pq.PQIndex.train(emb, **kw)
    index = pq.PQIndex.train(emb, device="cpu", **kw)
    index.chunk_size = min(chunk_size, index.n)
    np.testing.assert_array_equal(index.codebooks, jindex.codebooks)
    np.testing.assert_array_equal(index.codes, jindex.codes)
    assert index.codes.dtype == (np.uint8 if n_bits == 8 else np.uint16)
    if n_bits > 8:
        assert index._codes_dev.dtype == torch.int16 and int(index.codes.max()) >= 256
    got_ids, got = index.search(q, 20)
    want_ids, want = jindex.search(q, 20)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    recon = np.concatenate([index.codebooks[j][index.codes[:, j]] for j in range(index.m)], 1)
    np.testing.assert_array_equal(index.decompress(0, index.n).numpy(), recon)
    oracle = np.sort(q @ recon.T, axis=1)[:, ::-1][:, :20]
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-4)
    assert index.nbytes() == jindex.nbytes()
    index.save(str(tmp_path / "pq"))
    np.testing.assert_array_equal(pq.PQIndex.load(str(tmp_path / "pq"), **CPU).search(q, 20)[0],
                                  got_ids)


def test_pq_codes_past_codebook_rejected():
    books = np.zeros((2, 4, 4), np.float32)
    with pytest.raises(ValueError, match="only k=4 centroids"):
        pq.PQIndex(books, np.array([[0, 5]], np.uint8), **CPU)


def test_hit_at_k_and_oracle_order_match_jax():
    """hit@k (include and stem, default and custom cuts, saturation, short
    lists, no examples) and answer_bearing_first equal the originals."""
    data = make_examples(12, n_facts=7, seed=3)
    for ex in data[::3]:
        ex["fact"] = ex["fact"][:2]
    for hitk in ((1, 2, 3), (5, 1), None):
        kw = {} if hitk is None else {"hitk": hitk}
        assert hit_at_k(data, **kw) == jax_hit_at_k(data, **kw)
    assert hit_at_k([], hitk=(1, 5)) == jax_hit_at_k([], hitk=(1, 5))
    assert answer_bearing_first(data) == jax_answer_bearing_first(data)


def test_ranking_stats_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(20):
        perm = rng.permutation(int(rng.integers(1, 40)))
        assert count_inversions(perm) == jax_count_inversions(perm)
    scores = rng.normal(size=(6, 10)).astype(np.float32)
    scores[2, 4] = scores[2, 7]
    got = ([], {1: [], 3: []}, {1: [], 5: []})
    want = ([], {1: [], 3: []}, {1: [], 5: []})
    ranking_stats(scores, *got)
    jax_ranking_stats(scores, *want)
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_running_top_k_against_a_sort(seed):
    """RunningTopK over random chunks equals a stable sort by (score
    descending, row ascending) under lax.top_k's total order, on scores
    with tie groups across chunks, at and away from the k-th boundary, and
    with -0.0 and +0.0 at the boundary; both the float32 path and the keyed
    fallback run."""
    from lako_tpu_torch.retrieval.index import RunningTopK

    rng = np.random.default_rng(seed)
    Q, n, k = 9, 700, 50
    scores = rng.normal(size=(Q, n)).astype(np.float32)
    scores[0] = rng.integers(-3, 4, size=n)                  # ties everywhere
    scores[1, rng.choice(n, 80, replace=False)] = 5.0        # a group the boundary cuts
    scores[2, rng.choice(n, 30, replace=False)] = 5.0        # a group inside the k
    scores[3] = np.where(rng.random(n) < 0.5, -0.0, 0.0)     # signed zeros only
    scores[4, :] = -1.0
    scores[4, rng.choice(n, 60, replace=False)] = np.where(rng.random(60) < 0.5, -0.0, 0.0)
    bits = scores.view(np.int32)
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)                # total order, as lax.top_k
    want = np.stack([np.lexsort((np.arange(n), -mono[r].astype(np.int64)))[:k]
                     for r in range(Q)])
    cuts = np.sort(rng.choice(np.arange(1, n), size=int(rng.integers(0, 6)), replace=False))
    top = RunningTopK(k)
    for lo, hi in zip([0, *cuts], [*cuts, n]):
        top.add(torch.from_numpy(scores[:, lo:hi]), int(lo))
    got_s, got_rows = top.result()
    np.testing.assert_array_equal(got_rows.numpy(), want)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.take_along_axis(scores, want, 1).view(np.int32))
