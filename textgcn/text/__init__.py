from textgcn.text.datasets import DatasetLabels, load_labels  # noqa: F401
