from textgcn.parallel.partition import PartitionedGraph, partition_rows  # noqa: F401
from textgcn.parallel.sharded import (  # noqa: F401
    make_mesh,
    spmm_sharded,
    sharded_gcn_forward,
    make_sharded_train_step,
)
from textgcn.parallel.streamed import (  # noqa: F401
    halo_bucket_stream,
    make_streamed_sharded_train_step,
    make_streamed_sharded_train_step_segmented,
    spmm_streamed_mesh,
    spmm_streamed_mesh_multi,
)
