from textgcn.ops.spmm import spmm, spmm_coo_segment, spmm_dense  # noqa: F401
