from textgcn.utils.logging import LogResult, format_table, graph_stats  # noqa: F401
from textgcn.utils.config import ExperimentConfig  # noqa: F401
