from textgcn.models.gcn import GCN, gcn_init, gcn_forward  # noqa: F401
from textgcn.models.gat import gat_init, gat_forward  # noqa: F401
from textgcn.models.sgc import (  # noqa: F401
    sgc_init,
    sgc_forward,
    sgc_precompute,
    sgc_pre_forward,
)
from textgcn.models.appnp import appnp_init, appnp_forward  # noqa: F401
from textgcn.models.sage import sage_init, sage_forward  # noqa: F401
from textgcn.models.gin import gin_init, gin_forward  # noqa: F401
from textgcn.models.gcnii import gcnii_init, gcnii_forward  # noqa: F401

# Model-family registry: name -> (init, forward) with the uniform
# signatures init(key, n_feat, n_hidden, n_class) and
# forward(params, graph, x, *, dropout, train, rng). The trainer passes
# `forward` into its jitted steps as a static argument, so adding a family
# here makes it trainable end-to-end (TrainConfig.model / cli --model).
MODELS = {
    "gcn": (gcn_init, gcn_forward),
    "gat": (gat_init, gat_forward),
    "sgc": (sgc_init, sgc_forward),
    # linear head over features already propagated with sgc_precompute —
    # the compiled train step is gather-free
    "sgc_pre": (sgc_init, sgc_pre_forward),
    "appnp": (appnp_init, appnp_forward),
    # GraphSAGE mean aggregator: separate self/neighbor transforms per
    # layer — the node's own features are not degree-diluted
    "sage": (sage_init, sage_forward),
    # GIN: (1+eps)·h + Âh through a 2-layer MLP, learnable eps per layer
    "gin": (gin_init, gin_forward),
    # GCNII: K deep layers with initial residual + identity mapping
    # (deep receptive field without over-smoothing, scan over [K, H, H])
    "gcnii": (gcnii_init, gcnii_forward),
}
