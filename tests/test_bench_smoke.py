"""CPU smoke tests for bench.py's perf sections.

bench.py measures on the GPU; these tests execute the same functions at
tiny sizes on the CPU backend so API breakage shows here, not on the
card. Their timings mean nothing."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from textgcn.graph.normalize import sym_normalize_coo  # noqa: E402
from textgcn.graph.structs import SparseGraph  # noqa: E402
from textgcn.text.datasets import DatasetLabels  # noqa: E402
from textgcn.train.prepare import PreparedData  # noqa: E402


def _pre(n=600, seed=0):
    rng = np.random.RandomState(seed)
    hub = rng.randint(0, 100, (3000, 2))
    uni = rng.randint(0, n, (2000, 2))
    rc = np.vstack([hub, uni])
    row = np.r_[rc[:, 0], rc[:, 1]]
    col = np.r_[rc[:, 1], rc[:, 0]]
    r, c, v = sym_normalize_coo(row, col, np.ones_like(row, float), n)
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    y = rng.randint(0, 3, n)
    idx = rng.permutation(n)
    labels = DatasetLabels(
        target=y, label_names=["a", "b", "c"],
        train_idx=idx[: n // 2], test_idx=idx[n // 2:],
    )
    return PreparedData(
        graph=g, features=None, labels=labels, n_feat=n,
        num_docs=n, num_topics=0,
    )


def test_roofline_probe_smoke():
    probe = bench.roofline_probe(n=1 << 16, m=128)
    assert probe["stream_bytes_per_s"] > 0
    assert probe["matmul_bf16_flops"] > 0
    assert probe["matmul_f32_default_flops"] > 0


def test_kernel_pass_perf_smoke():
    out = bench.spmm_pass_perf(_pre(), f=16, reps=1)
    assert out["device"]["platform"] == "cpu"
    for fmt in ("segment", "dense"):
        rec = out[fmt]
        assert rec["pass_ms"] > 0
        assert rec["bound_ms"] > 0
        assert rec["roofline_share"] > 0


@pytest.mark.parametrize("model", ["gcn", "gat"])
@pytest.mark.parametrize("fmt", ["segment", "dense"])
def test_time_train_epochs_smoke(fmt, model):
    rec = bench.time_train_epochs(_pre(seed=1), fmt, n_epochs=2, model=model)
    assert rec["epoch_ms"] > 0
    assert np.isfinite(rec["train_loss_last"])


def test_streamed_mesh_scale_perf_smoke(monkeypatch):
    """The streamed-mesh bench section (parallel/streamed.py over every
    visible device: 8 virtual CPU devices here) runs at tiny size."""
    res = bench.streamed_mesh_scale_perf(n=2048, deg=4, f=16, chunk=2048)
    assert res["n_shards"] == 8
    assert res["edges_per_s_per_shard"] > 0


def test_streamed_scale_perf_smoke():
    res = bench.streamed_scale_perf(n=2048, deg=4, f=16, chunk=2048)
    assert res["full_pass_s"] > 0


@pytest.mark.parametrize("model", ["gcn", "sgc"])
def test_streamed_sgc_train_perf_smoke(model):
    res = bench.streamed_train_perf(
        n=2048, deg=4, f=16, h=8, c=4, chunk=2048, model=model
    )
    assert np.isfinite(res["loss"])
    assert res["s_per_step"] > 0


def test_synthetic_large_mesh_stream_smoke(capsys):
    """benchmarks/synthetic_large.py --mesh_stream end-to-end at tiny
    size on the virtual mesh (both phases emit their JSON lines)."""
    import json as _json

    sys.path.insert(
        0,
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "benchmarks",
        ),
    )
    import synthetic_large

    sys.argv = [
        "synthetic_large", "--mesh_stream", "--n", "1024", "--deg", "4",
        "--f", "16", "--hidden", "8", "--classes", "4", "--chunk",
        "16384", "--shards", "4",
    ]
    assert synthetic_large.main() == 0
    lines = [
        _json.loads(ln)
        for ln in capsys.readouterr().out.strip().splitlines()
        if ln.startswith("{")
    ]
    phases = {r["phase"] for r in lines}
    assert "spmm_streamed_mesh" in phases
    assert "train_step_streamed_mesh_gcn" in phases
