"""textgcn — graph-convolutional networks for text classification in JAX.

A from-scratch JAX/XLA re-design of the TopicGCN/TextGCN capability set
(reference: anargh-t/Graph-Convolutional-Networks-for-Text-Classification):

- text corpus cleaning and dataset loading              (``textgcn.text``)
- LDA topic modeling + Word2Vec topic embeddings,
  both implemented natively in JAX                      (``textgcn.topics``)
- document–topic–topic and document–word graph
  construction with symmetric normalization             (``textgcn.graph``)
- sparse matmul (SpMM): segment-sum reference, dense
  GEMM and host-fed edge streams                        (``textgcn.ops``)
- GCN-family models as pure-functional pytrees          (``textgcn.models``)
- jitted full-batch semi-supervised training with
  early stopping, metrics and multi-seed reports        (``textgcn.train``)
- multi-device execution over a ``jax.sharding.Mesh``   (``textgcn.parallel``)
- the accelerator's published peaks and memory budgets  (``textgcn.device``)
"""

__version__ = "0.1.0"

from textgcn.graph.structs import SparseGraph  # noqa: F401
