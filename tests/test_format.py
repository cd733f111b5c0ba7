"""Graph formats against a float64 scipy oracle, forward AND VJP, over
graph kinds and feature widths; the device table and the ``auto`` choice;
and the training-path integration of the formats."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from textgcn import device as D
from textgcn.graph.format import (
    SPMM_FORMATS,
    choose_format,
    convert_graph,
    estimate_pass_seconds,
)
from textgcn.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn.graph.structs import DenseGraph, SparseGraph, StreamedGraph
from textgcn.ops.spmm import spmm, spmm_streamed

N = 256  # one node count for every kind, so compiled passes are shared
E_PAD = 8192  # padded edge count shared by every kind
CHUNK = 2048  # streamed chunk: four chunks per graph


def _sym_norm(src, dst, w, n=N):
    r, c, v = max_symmetrize_coo(src, dst, w, n)
    return sym_normalize_coo(r, c, v, n)


def _kind(kind: str):
    """(row, col, val) of one graph kind on N nodes."""
    rng = np.random.RandomState(KINDS.index(kind))
    if kind == "uniform":
        src, dst = rng.randint(0, N, 1500), rng.randint(0, N, 1500)
        return _sym_norm(src, dst, rng.rand(1500) + 0.05)
    if kind == "powerlaw_hubs":
        # Zipf-distributed endpoints: a few hub rows hold most edges
        src = np.minimum(rng.zipf(1.6, 2000) - 1, N - 1)
        dst = rng.randint(0, N, 2000)
        return _sym_norm(src, dst, rng.rand(2000) + 0.05)
    if kind == "doc_topic":
        # 224 docs each linked to ~5 of 32 topics, plus topic-topic edges
        docs, topics = 224, 32
        d = np.repeat(np.arange(docs), 5)
        t = rng.randint(0, topics, len(d)) + docs
        ti, tj = np.triu_indices(topics, k=1)
        keep = rng.rand(len(ti)) < 0.2
        src = np.concatenate([d, ti[keep] + docs])
        dst = np.concatenate([t, tj[keep] + docs])
        return _sym_norm(src, dst, rng.rand(len(src)) + 0.05)
    if kind == "empty_rows":
        # the upper half of the nodes has no edge at all
        src, dst = rng.randint(0, N // 2, 800), rng.randint(0, N // 2, 800)
        r, c, v = max_symmetrize_coo(src, dst, rng.rand(800) + 0.05, N)
        return r, c, v
    if kind == "self_loops":
        idx = np.arange(N)
        src = np.concatenate([idx, rng.randint(0, N, 400)])
        dst = np.concatenate([idx, rng.randint(0, N, 400)])
        return _sym_norm(src, dst, rng.rand(len(src)) + 0.05)
    if kind == "phantom_padding":
        # 40 real edges in a buffer padded to E_PAD: almost all phantom
        src, dst = rng.randint(0, N, 20), rng.randint(0, N, 20)
        return _sym_norm(src, dst, rng.rand(20) + 0.05)
    if kind == "nonsymmetric":
        src, dst = rng.randint(0, N, 1200), rng.randint(0, N, 1200)
        m = sp.coo_matrix((rng.randn(1200), (src, dst)), shape=(N, N))
        m.sum_duplicates()
        return m.row, m.col, m.data
    raise ValueError(kind)


KINDS = (
    "uniform", "powerlaw_hubs", "doc_topic", "empty_rows", "self_loops",
    "phantom_padding", "nonsymmetric",
)
WIDTHS = (1, 8, 200)


def _graph(kind):
    r, c, v = _kind(kind)
    g = SparseGraph.from_coo(r, c, v, N, pad_to_multiple=E_PAD)
    assert g.n_padded_edges == E_PAD
    a = sp.coo_matrix((v, (r, c)), shape=(N, N)).toarray()
    return g, a


def _streamed_fn(sg: StreamedGraph):
    """The device-side edge stream over a StreamedGraph's chunks (padded
    to a fixed chunk count so every kind shares one compiled pass)."""
    row = np.full((4, CHUNK), N, np.int32)
    col = np.full((4, CHUNK), N, np.int32)
    val = np.zeros((4, CHUNK), np.float32)
    flat = slice(0, sg.row.size)
    row.reshape(-1)[flat] = sg.row.reshape(-1)
    col.reshape(-1)[flat] = sg.col.reshape(-1)
    val.reshape(-1)[flat] = sg.val.reshape(-1)
    return jnp.asarray(row), jnp.asarray(col), jnp.asarray(val)


def _chunk_fn(i, row, col, val):
    return row[i], col[i], val[i]


@pytest.mark.parametrize("direction", ["forward", "vjp"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["segment", "dense", "streamed"])
def test_format_matches_float64_oracle(fmt, kind, width, direction):
    """Â @ x, and its VJP Âᵀ @ g, through each format against a float64
    scipy product (f32 arithmetic on the CPU: rtol 1e-4)."""
    g, a = _graph(kind)
    rng = np.random.RandomState(width)
    x = rng.randn(N, width).astype(np.float32)
    ct = rng.randn(N, width).astype(np.float32)
    want = a @ x if direction == "forward" else a.T @ ct
    if fmt == "streamed":
        sg = StreamedGraph.from_coo(
            np.asarray(g.row)[: g.n_edges], np.asarray(g.col)[: g.n_edges],
            np.asarray(g.val)[: g.n_edges], N, chunk_e=CHUNK,
        )
        if direction == "forward":
            got = spmm(sg, jnp.asarray(x))
        else:
            chunks = _streamed_fn(sg)

            def f(z):
                return spmm_streamed(
                    lambda i: _chunk_fn(i, *chunks), z, N, 4
                )

            got = jax.vjp(f, jnp.asarray(x))[1](jnp.asarray(ct))[0]
    else:
        conv = convert_graph(g, fmt)
        if direction == "forward":
            got = spmm(conv, jnp.asarray(x))
        else:
            got = jax.vjp(lambda z: spmm(conv, z), jnp.asarray(x))[1](
                jnp.asarray(ct)
            )[0]
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4, atol=1e-5
    )


def test_streamed_graph_chunks_and_padding():
    """StreamedGraph pads its last chunk with dropped phantom edges."""
    row, col, val = np.array([0, 1, 2]), np.array([1, 2, 0]), np.ones(3)
    sg = StreamedGraph.from_coo(row, col, val, 5, chunk_e=2048)
    assert sg.n_chunks == 1 and sg.row.shape == (1, 1024)
    assert (sg.row[0, 3:] == 5).all() and (sg.val[0, 3:] == 0).all()
    assert len(list(sg.chunks())) == 1


def test_dense_graph_matches_scipy():
    g, a = _graph("uniform")
    d = DenseGraph.from_sparse_graph(g)
    np.testing.assert_allclose(np.asarray(d.a), a, rtol=1e-6)


def test_convert_graph_rejects_unknown_format():
    g, _ = _graph("uniform")
    with pytest.raises(ValueError, match="unknown spmm format"):
        convert_graph(g, "bsr")
    assert SPMM_FORMATS == ("auto", "segment", "dense", "streamed")


# ---------------------------------------------------------------------------
# the device table and the auto choice
# ---------------------------------------------------------------------------


H100 = D.DEVICES["NVIDIA H100 80GB HBM3"]


def test_h100_entry_holds_published_peaks():
    assert H100.hbm_bytes_per_s == 3.35e12
    assert H100.bf16_flops == 989e12
    assert H100.tf32_flops == 495e12
    assert H100.memory_bytes == 80 * 10**9
    assert "datasheet" in H100.source


def test_unknown_device_kind_raises(monkeypatch):
    monkeypatch.delitem(D.DEVICES, "cpu", raising=False)
    with pytest.raises(ValueError, match="no device model"):
        D.device_model()
    g, _ = _graph("uniform")
    with pytest.raises(ValueError, match="no device model"):
        convert_graph(g, "auto")


@pytest.mark.parametrize(
    "limit, dense_nodes",
    [(63_763_120_128, 44_638), (8 * 4 * 1000 * 1000, 1000), (0, 50_000)],
)
def test_budgets_follow_bytes_limit(limit, dense_nodes):
    """Budgets are fractions of the process's byte limit (the card's
    capacity when none is known); the dense cap is the largest N whose
    f32 [N, N] table fits the dense budget."""
    dm = dataclasses.replace(H100, bytes_limit=limit)
    base = limit or H100.memory_bytes
    assert dm.resident_bytes_budget == int(base * D.RESIDENT_FRACTION)
    assert dm.gather_bytes_limit == int(base * D.GATHER_FRACTION)
    assert dm.dense_max_nodes == dense_nodes
    assert 4 * dm.dense_max_nodes**2 <= dm.dense_bytes_budget
    assert 4 * (dm.dense_max_nodes + 1) ** 2 > dm.dense_bytes_budget


def test_gather_limit_is_fixed_on_the_host():
    assert D.gather_bytes_limit() == D.HOST_GATHER_BYTES_LIMIT


def _fake_graph(n, e):
    """A SparseGraph-shaped stand-in: choose_format reads sizes only."""
    return SparseGraph(row=None, col=None, val=None, n_nodes=n, n_edges=e)


@pytest.mark.parametrize(
    "n, e, want",
    [
        (7_724, 73_760, "segment"),  # R8 topic
        (15_362, 3_454_070, "segment"),  # R8 doc-word
        (29_426, 1_906_476, "segment"),  # mr doc-word
        (4_000, 1_000_000, "dense"),  # 6% dense: past the crossover
        (60_000, 30_000_000, "segment"),  # [N, N] table over budget
        (10_000_000, 500_000_000, "segment"),  # 22 GB: fits 60 GB resident
        (111_000_000, 1_600_000_000, "streamed"),  # over resident budget
    ],
)
def test_auto_chooses_from_graph_and_device(n, e, want):
    dm = dataclasses.replace(H100, bytes_limit=63_763_120_128)
    assert choose_format(_fake_graph(n, e), f=200, model=dm) == want


def test_auto_estimates_scale_with_the_device():
    """A faster memory makes the dense pass cheaper and leaves the segment
    estimate alone: the choice follows the device, not the caller."""
    fast = dataclasses.replace(H100, hbm_bytes_per_s=2 * H100.hbm_bytes_per_s)
    a = estimate_pass_seconds(15_362, 3_454_070, 200, H100)
    b = estimate_pass_seconds(15_362, 3_454_070, 200, fast)
    assert b["dense"] < a["dense"] and b["segment"] == a["segment"]


def test_convert_graph_auto_uses_explicit_model():
    g, _ = _graph("uniform")
    dense_cheap = dataclasses.replace(H100, dense_pass_efficiency=1e6)
    assert isinstance(convert_graph(g, "auto", model=dense_cheap), DenseGraph)
    assert convert_graph(g, "auto", model=H100) is g


# ---------------------------------------------------------------------------
# training-path integration
# ---------------------------------------------------------------------------


def _prepared(seed=0):
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from __graft_entry__ import _synthetic_graph

    from textgcn.text.datasets import DatasetLabels
    from textgcn.train.prepare import PreparedData

    g, x, y = _synthetic_graph(n_docs=120, n_topics=12, n_feat=20, seed=seed)
    n_docs = 120
    rng = np.random.RandomState(seed)
    is_train = rng.rand(n_docs) < 0.7
    idx = np.arange(n_docs)
    labels = DatasetLabels(
        target=(y[:n_docs] % 4).astype(np.int64),
        label_names=["a", "b", "c", "d"],
        train_idx=idx[is_train],
        test_idx=idx[~is_train],
    )
    return PreparedData(
        graph=g,
        features=x,
        labels=labels,
        n_feat=x.shape[1],
        num_docs=n_docs,
        num_topics=12,
    )


@pytest.mark.parametrize("fmt", ["dense", "auto"])
def test_apply_spmm_format_trains_to_same_accuracy(fmt):
    """Training through each resident format reaches the same test
    accuracy as the segment oracle path (numerics differ only by
    summation order)."""
    from textgcn.train.prepare import apply_spmm_format
    from textgcn.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        n_hidden=16, max_epoch=30, early_stopping=30, dropout=0.0, seed=1
    )

    results = {}
    for use in ("segment", fmt):
        pre = apply_spmm_format(_prepared(), use)
        t = Trainer(
            pre.graph,
            pre.features,
            pre.labels.target,
            pre.labels.train_idx,
            pre.labels.test_idx,
            pre.labels.n_classes,
            config=cfg,
        )
        t.fit(verbose=False)
        results[use] = t.test()["acc"]
    assert abs(results[fmt] - results["segment"]) < 0.05, results


def test_run_experiment_refuses_streamed_graph(tmp_path):
    """A graph past the resident budget is not handed to the Trainer."""
    from textgcn.train.run import run_experiment
    from textgcn.train.trainer import TrainConfig

    with pytest.raises(ValueError, match="resident budget"):
        run_experiment(
            "toy", pre_data=_prepared(), output_dir=str(tmp_path),
            config=TrainConfig(spmm="streamed", max_epoch=1), verbose=False,
        )
