"""Worker process for the 2-process ``jax.distributed`` test.

Launched by tests/test_distributed.py as
``python tests/distributed_worker.py --port P --pid {0,1} --out FILE``.
Each process brings 4 virtual CPU devices; ``init_distributed`` connects
them into one 8-device job, and a sharded GCN train step runs over the
GLOBAL mesh — the same computation the single-process 8-device test
performs, so the losses must match.

Order matters: the platform is forced to CPU immediately after
``import jax``, and ``jax.distributed.initialize`` must run before any
other API touches the backend.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    from textgcn.parallel.distributed import (
        DistributedConfig,
        global_mesh,
        init_distributed,
        process_summary,
    )

    ok = init_distributed(
        DistributedConfig(
            coordinator_address=f"localhost:{args.port}",
            num_processes=args.nproc,
            process_id=args.pid,
        )
    )
    assert ok, "init_distributed must report multiprocess"
    assert jax.process_count() == args.nproc
    assert jax.device_count() == 4 * args.nproc
    print(process_summary(), file=sys.stderr, flush=True)

    mesh = global_mesh()
    loss = run_global_step(mesh)
    s_ring, s_halo = run_global_streams(mesh)
    s_attn = run_global_attention(mesh)

    if jax.process_index() == 0:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(f"{loss!r},{s_ring!r},{s_halo!r},{s_attn!r}\n")
    # clean shutdown so the coordinator releases the barrier
    jax.distributed.shutdown()
    return 0


def make_problem(n_shards: int):
    """Deterministic toy problem — every process (and the single-process
    control in test_distributed.py) builds bit-identical inputs."""
    import os

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from __graft_entry__ import _synthetic_graph
    from textgcn.models.gcn import gcn_init
    from textgcn.parallel.partition import pad_features, partition_rows

    import jax

    g, x, y = _synthetic_graph(n_docs=96, n_topics=16, n_feat=32, seed=0)
    pg = partition_rows(g, n_shards)
    xp = pad_features(x, pg.n_pad)
    yp = np.zeros(pg.n_pad, dtype=np.int32)
    yp[: len(y)] = y % 8
    w = np.zeros(pg.n_pad, dtype=np.float32)
    w[: g.n_nodes] = (np.random.RandomState(1).rand(g.n_nodes) < 0.5).astype(
        np.float32
    )
    params = gcn_init(jax.random.PRNGKey(0), x.shape[1], 16, 8)
    return pg, xp, yp, w, params


def run_global_step(mesh) -> float:
    """One sharded train step over ``mesh`` (works for a single-process
    virtual mesh AND a multi-process global mesh: arrays are assembled
    shard-by-shard via make_array_from_callback, which only materializes
    the addressable shards on each process)."""
    import dataclasses

    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from textgcn.parallel.sharded import AXIS, make_sharded_train_step

    n_shards = mesh.devices.size
    pg, xp, yp, w, params = make_problem(n_shards)

    def put(arr, spec):
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
        )

    pg = dataclasses.replace(
        pg,
        row=put(pg.row, P(AXIS)),
        col=put(pg.col, P(AXIS)),
        val=put(pg.val, P(AXIS)),
    )
    xs = put(xp, P(AXIS, None))
    ys = put(yp, P(AXIS))
    ws = put(w, P(AXIS))
    params = jax.tree_util.tree_map(lambda a: put(a, P()), params)

    opt = optax.adam(1e-2)
    step = make_sharded_train_step(pg, mesh, opt, dropout=0.0)
    opt_state = jax.tree_util.tree_map(
        lambda a: put(a, P()), opt.init(jax.tree_util.tree_map(np.asarray,
                                                              params))
    )
    _, _, loss = step(params, opt_state, xs, ys, ws, jax.random.PRNGKey(1))
    return float(loss)


def run_global_streams(mesh):
    """The streamed ppermute ring over PRNG buckets AND over a real
    graph's halo buckets, both on ``mesh``. Returns replicated global
    checksums so the multi-process job can be asserted equal to the
    single-process control."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from textgcn.graph.structs import SparseGraph
    from textgcn.parallel.halo import partition_rows_halo
    from textgcn.parallel.streamed import (
        halo_bucket_stream,
        make_random_bucket_edge_fn,
        spmm_streamed_mesh,
    )

    n_shards = mesh.devices.size

    def put(arr, spec):
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
        )

    gsum = jax.jit(jnp.sum)

    # PRNG bucket ring (no edge_args): ppermute + chunk loops across the
    # process boundary
    rps = 16
    edge_fn = make_random_bucket_edge_fn(rps, chunk_e=32, seed=5)
    dims = (rps, n_shards, 3)
    x1 = np.random.RandomState(7).randn(rps * n_shards, 8).astype(
        np.float32
    )
    out1 = spmm_streamed_mesh(edge_fn, put(x1, P("nodes", None)), mesh,
                              dims)
    s_ring = float(gsum(out1))

    # real symmetric graph -> halo buckets streamed around the ring
    rng = np.random.RandomState(3)
    n, e = 128, 600
    row = rng.randint(0, n, e)
    col = rng.randint(0, n, e)
    val = rng.rand(e)
    g = SparseGraph.from_coo(
        np.concatenate([row, col]), np.concatenate([col, row]),
        np.concatenate([val, val]), n, pad_to_multiple=8,
    )
    hg = partition_rows_halo(g, n_shards, pad_edges_to_multiple=8)
    h_fn, h_chunks, h_args = halo_bucket_stream(hg, chunk_e=64)
    h_args = tuple(put(a, P("nodes")) for a in h_args)
    x2 = np.random.RandomState(9).randn(hg.n_pad, 16).astype(np.float32)
    out2 = spmm_streamed_mesh(
        h_fn, put(x2, P("nodes", None)), mesh,
        (hg.rows_per_shard, n_shards, h_chunks), h_args,
    )
    s_halo = float(gsum(out2))
    return s_ring, s_halo


def run_global_attention(mesh) -> float:
    """The sharded GAT attention aggregation (allgather partition,
    parallel/sharded.py) over ``mesh``: all-gather of the projected rows
    plus a shard-local segment softmax, across the process boundary."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from textgcn.graph.structs import SparseGraph
    from textgcn.parallel.partition import partition_rows
    from textgcn.parallel.sharded import _gat_attention_agg

    n_shards = mesh.devices.size

    def put(arr, spec):
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
        )

    rng = np.random.RandomState(13)
    n, e, f = 96, 500, 8
    g = SparseGraph.from_coo(
        rng.randint(0, n, e), rng.randint(0, n, e),
        rng.rand(e) + 0.1, n,
    )
    pg = partition_rows(g, n_shards)
    pg = jax.tree_util.tree_map(lambda a: put(a, P("nodes")), pg)
    h = np.zeros((pg.n_pad, f), np.float32)
    h[:n] = rng.randn(n, f)
    a_s = rng.randn(f).astype(np.float32)
    a_d = rng.randn(f).astype(np.float32)
    out = jax.jit(
        lambda p_, s_, d_, x_: _gat_attention_agg(s_, d_, p_, x_, mesh)
    )(pg, put(a_s, P()), put(a_d, P()), put(h, P("nodes", None)))
    return float(jax.jit(jnp.sum)(out))


if __name__ == "__main__":
    raise SystemExit(main())
