from textgcn.graph.structs import (  # noqa: F401
    DenseGraph,
    SparseGraph,
    StreamedGraph,
)
from textgcn.graph.normalize import (  # noqa: F401
    sym_normalize_coo,
    add_self_loops_coo,
    max_symmetrize_coo,
)
