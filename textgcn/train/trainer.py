"""Full-batch semi-supervised GCN training, jit-compiled.

Capability parity with the reference's ``TopicGCNTrainer``
(reference trainer.py:264-406), re-designed for a compiled accelerator step:

- one compiled ``train_step`` (forward + masked CE + Adam update) and one
  compiled ``eval_step``; the 200-epoch loop runs on host but each step is a
  single XLA program with zero per-epoch host↔device traffic except the
  scalar metrics readback (the reference pays the same: trainer.py:367);
- dropout via explicit PRNG keys (folded per-epoch);
- early stopping on val loss with the reference's patience semantics
  (reference utils.py:216-266), with an optional best-params snapshot —
  the reference's checkpoint path is dead code (utils.py:244,254), we keep
  ``restore_best=False`` by default for behavioral parity;
- the loss is cross-entropy **on train-node logits only** (semi-supervised
  masking, reference trainer.py:358-359).
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from textgcn.models.gcn import gcn_forward, gcn_init
from textgcn.train.metrics import accuracy, macro_f1


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters; defaults mirror the reference (trainer.py:425-431)."""

    n_hidden: int = 200
    lr: float = 0.02
    dropout: float = 0.5
    max_epoch: int = 200
    early_stopping: int = 10
    val_ratio: float = 0.1
    seed: int = 42
    restore_best: bool = False
    # epochs per compiled scan block (1 = epoch-at-a-time dispatch);
    # results are bit-identical across block sizes.
    epoch_block: int = 10
    # SpMM graph format (textgcn.graph.format.SPMM_FORMATS):
    # auto | segment | dense | streamed. Applied by run_experiment via
    # apply_spmm_format before the Trainer is built.
    spmm: str = "auto"
    # model family (textgcn.models.MODELS): gcn | gat | sgc | sgc_pre |
    # appnp | sage | gin | gcnii. GAT runs on the segment COO stream or the
    # dense log-adjacency (spmm dense/auto -> DenseAttentionGraph); the
    # others train through any resident SpMM format.
    model: str = "gcn"


class EarlyStopping:
    """Patience counter on val loss (reference utils.py:216-266)."""

    def __init__(self, patience: int = 10, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.best_score: Optional[float] = None
        self.counter = 0

    def __call__(self, val_loss: float) -> bool:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            return False
        if score < self.best_score + self.delta:
            self.counter += 1
            return self.counter >= self.patience
        self.best_score = score
        self.counter = 0
        return False


def train_val_split(
    train_idx: np.ndarray, val_ratio: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled split of the labeled train set into train/val.

    The reference uses sklearn ``train_test_split`` (trainer.py:335-338);
    this is the same uniform shuffled split via numpy (documented deviation:
    the exact permutation differs from sklearn's for a given seed).
    """
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(train_idx))
    n_val = int(round(len(train_idx) * val_ratio))
    return np.asarray(train_idx)[perm[n_val:]], np.asarray(train_idx)[perm[:n_val]]


def _adam(lr: float = 0.02):
    # Adam with the reference's defaults (torch.optim.Adam: b1=0.9, b2=0.999,
    # eps=1e-8; reference trainer.py:307). lr is injected via inject_hyperparams
    # so one compiled step serves any lr; callers may still override the
    # runtime value through ``opt_state.hyperparams["learning_rate"]``.
    return optax.inject_hyperparams(optax.adam)(learning_rate=lr)


@partial(jax.jit, static_argnames=("num_classes", "forward"))
def _eval_step(params, graph, x, y, idx, num_classes, forward=gcn_forward):
    logits = forward(params, graph, x, train=False)
    sl = logits[idx]
    st = y[idx]
    loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(sl, st))
    acc = accuracy(sl, st)
    f1, p, r = macro_f1(sl, st, num_classes)
    return loss, acc, f1, p, r


@partial(
    jax.jit,
    static_argnames=("dropout", "num_classes", "forward"),
    donate_argnums=(0, 1),
)
def _train_block(
    params, opt_state, rngs, graph, x, y, train_idx, val_idx, num_classes,
    dropout, forward=gcn_forward,
):
    """Run ``len(rngs)`` epochs in ONE device dispatch via ``lax.scan``.

    Per-epoch host↔device round trips dominate full-batch GCN training on
    this small model (the compute per epoch is ~ms); batching epochs into a
    scan amortizes dispatch ~blockx. Per-epoch parameter snapshots are
    stacked in the scan outputs so host-side early stopping can recover the
    exact params at the stopping epoch — bit-identical semantics to the
    epoch-at-a-time loop.
    """

    def epoch(carry, rng):
        params, opt_state = carry

        def loss_fn(p):
            logits = forward(
                p, graph, x, dropout=dropout, train=True, rng=rng
            )
            tl = logits[train_idx]
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(
                    tl, y[train_idx]
                )
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = _adam().update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        logits = forward(params, graph, x, train=False)
        sl = logits[val_idx]
        st = y[val_idx]
        vloss = jnp.mean(
            optax.softmax_cross_entropy_with_integer_labels(sl, st)
        )
        vacc = accuracy(sl, st)
        vf1, vp, vr = macro_f1(sl, st, num_classes)
        return (params, opt_state), (params, loss, vloss, vacc, vf1, vp, vr)

    (params, opt_state), outs = jax.lax.scan(epoch, (params, opt_state), rngs)
    return params, opt_state, outs


def _progress_metadata(
    epoch: int,
    best_val: float,
    stopper_best: float,
    stopper_counter: int,
    stopped: int,
    seed: int,
) -> Dict[str, np.ndarray]:
    """Training-progress counters as a flat numpy dict (checkpoint schema —
    doubles as the restore template)."""
    return {
        "epoch": np.asarray(epoch, dtype=np.int64),
        "best_val": np.asarray(best_val, dtype=np.float64),
        "stopper_best": np.asarray(stopper_best, dtype=np.float64),
        "stopper_counter": np.asarray(stopper_counter, dtype=np.int64),
        "stopped": np.asarray(stopped, dtype=np.int64),
        "seed": np.asarray(seed, dtype=np.int64),
    }


class Trainer:
    """Trains a 2-layer GCN full-batch on a prepared graph."""

    def __init__(
        self,
        graph,
        features: jnp.ndarray,
        target: np.ndarray,
        train_idx: np.ndarray,
        test_idx: np.ndarray,
        num_classes: int,
        config: TrainConfig = TrainConfig(),
    ):
        self.graph = graph
        # features=None → identity features (classic TextGCN); layer 1
        # becomes an embedding table of shape [n_nodes, n_hidden]
        self.x = (
            None
            if features is None
            else jnp.asarray(features, dtype=jnp.float32)
        )
        self.y = jnp.asarray(np.asarray(target), dtype=jnp.int32)
        self.train_idx_all = np.asarray(train_idx)
        self.test_idx = jnp.asarray(np.asarray(test_idx), dtype=jnp.int32)
        self.num_classes = int(num_classes)
        self.cfg = config
        self.history: List[Dict[str, float]] = []
        self.params = None
        self.train_time = 0.0
        self.model_param = 0

    def fit(
        self, verbose: bool = True, resume_from: Optional[str] = None
    ) -> Dict[str, Any]:
        """Train to ``max_epoch`` or early stop.

        ``resume_from``: checkpoint directory written by
        :meth:`save_training_state` — params, optimizer state, epoch
        counter, and early-stop state are restored and training continues
        with the SAME per-epoch dropout-key stream (keys are derived from
        ``cfg.seed`` upfront), so an interrupted-then-resumed run is
        bit-identical to an uninterrupted one (test-pinned). The reference
        cannot resume at all — its checkpoint path is dead code
        (reference utils.py:244,254).
        """
        cfg = self.cfg
        tr, va = train_val_split(self.train_idx_all, cfg.val_ratio, cfg.seed)
        train_idx = jnp.asarray(tr, dtype=jnp.int32)
        val_idx = jnp.asarray(va, dtype=jnp.int32)

        key = jax.random.PRNGKey(cfg.seed)
        key, init_key = jax.random.split(key)
        n_feat = (
            self.graph.n_nodes if self.x is None else self.x.shape[1]
        )
        init_fn, self._forward = self._model_fns()
        params = init_fn(
            init_key, n_feat, cfg.n_hidden, self.num_classes
        )
        self.model_param = sum(
            int(p.size) for p in jax.tree_util.tree_leaves(params)
        )
        opt = _adam()
        opt_state = opt.init(params)
        opt_state.hyperparams["learning_rate"] = jnp.asarray(
            cfg.lr, dtype=jnp.float32
        )
        stopper = EarlyStopping(cfg.early_stopping)

        best_val = np.inf
        start_epoch = 0
        if resume_from is not None:
            if cfg.restore_best:
                raise ValueError(
                    "resume_from tracks the live training state; "
                    "restore_best snapshots are not part of it"
                )
            from textgcn.train.checkpoint import restore_checkpoint

            template = {
                "params": params,
                "opt_state": opt_state,
                "metadata": _progress_metadata(0, np.inf, np.inf, 0, 0,
                                               cfg.seed),
            }
            state = restore_checkpoint(resume_from, template=template)
            md = state["metadata"]
            if int(md["stopped"]):
                raise ValueError(
                    f"checkpoint {resume_from} is from an early-stopped "
                    "run; there is nothing to resume"
                )
            params = state["params"]
            opt_state = state["opt_state"]
            start_epoch = int(md["epoch"])
            best_val = float(md["best_val"])
            sb = float(md["stopper_best"])
            stopper.best_score = None if np.isinf(sb) else sb
            stopper.counter = int(md["stopper_counter"])

        best_params = params
        start = time.time()
        block = max(1, cfg.epoch_block)
        # one dropout key per epoch, derived upfront so the training
        # trajectory is identical for any epoch_block choice (and across
        # interrupt/resume boundaries)
        all_rngs = jax.random.split(key, cfg.max_epoch)
        epoch = start_epoch
        stopped = False
        while epoch < cfg.max_epoch and not stopped:
            n_epochs = min(block, cfg.max_epoch - epoch)
            rngs = all_rngs[epoch : epoch + n_epochs]
            params, opt_state, outs = _train_block(
                params,
                opt_state,
                rngs,
                self.graph,
                self.x,
                self.y,
                train_idx,
                val_idx,
                self.num_classes,
                cfg.dropout,
                self._forward,
            )
            s_params, tloss, vloss, vacc, vf1, vp, vr = outs
            tloss, vloss, vacc, vf1, vp, vr = (
                np.asarray(a)
                for a in (tloss, vloss, vacc, vf1, vp, vr)
            )
            for j in range(n_epochs):
                rec = {
                    "epoch": epoch,
                    "train_loss": float(tloss[j]),
                    "val_loss": float(vloss[j]),
                    "acc": float(vacc[j]),
                    "macro_f1": float(vf1[j]),
                    "precision": float(vp[j]),
                    "recall": float(vr[j]),
                }
                self.history.append(rec)
                epoch += 1
                if verbose:
                    print(
                        " ".join(
                            f"{k}:{v}" if isinstance(v, int) else f"{k}:{v:.4f}"
                            for k, v in rec.items()
                        )
                    )
                if rec["val_loss"] < best_val:
                    best_val = rec["val_loss"]
                    if cfg.restore_best:
                        best_params = jax.tree_util.tree_map(
                            lambda a: np.asarray(a[j]), s_params
                        )
                if stopper(rec["val_loss"]):
                    # restore the exact params at the stopping epoch
                    params = jax.tree_util.tree_map(
                        lambda a: jnp.asarray(a[j]), s_params
                    )
                    stopped = True
                    break
        self.train_time = time.time() - start
        self.params = best_params if cfg.restore_best else params
        # live training state for save_training_state (mid-training resume);
        # under restore_best self.params is the best-epoch snapshot, which
        # must NOT be checkpointed next to the final epoch's Adam moments —
        # the resumable state is always the end-of-run params
        self._live_params = params
        self._opt_state = opt_state
        self._best_val = best_val
        self._stopper = stopper
        self._epochs_done = epoch
        self._stopped = stopped
        return {"epochs_run": len(self.history), "train_time": self.train_time}

    def save_training_state(self, path: str) -> str:
        """Resumable checkpoint: params + optimizer state + progress.

        Unlike :meth:`save` (params only, for serving/eval), this captures
        everything :meth:`fit` needs to CONTINUE training — Adam moments,
        epoch counter, best-val-loss, early-stop patience state — so an
        interrupted run resumed via ``fit(resume_from=...)`` reproduces the
        uninterrupted trajectory exactly.
        """
        from textgcn.train.checkpoint import save_checkpoint

        if self.params is None or not hasattr(self, "_opt_state"):
            raise ValueError("fit() first")
        st = self._stopper
        return save_checkpoint(
            path,
            self._live_params,
            opt_state=self._opt_state,
            metadata=_progress_metadata(
                self._epochs_done,
                self._best_val,
                np.inf if st.best_score is None else st.best_score,
                st.counter,
                int(self._stopped),
                self.cfg.seed,
            ),
        )

    def _model_fns(self):
        from textgcn.models import MODELS

        model = getattr(self.cfg, "model", "gcn")
        if model not in MODELS:
            raise ValueError(
                f"unknown model {model!r}; choose one of {sorted(MODELS)}"
            )
        from textgcn.graph.structs import SparseGraph
        from textgcn.models.gat import DenseAttentionGraph

        if model == "gat" and not isinstance(
            self.graph, (SparseGraph, DenseAttentionGraph)
        ):
            raise ValueError(
                "GAT needs the segment (COO) format or the dense "
                "small-graph DenseAttentionGraph (spmm='dense'/'auto'); "
                f"got {type(self.graph).__name__}"
            )
        return MODELS[model]

    def evaluate(self, idx: jnp.ndarray, prefix: str = "test") -> Dict[str, float]:
        loss, acc, f1, p, r = _eval_step(
            self.params, self.graph, self.x, self.y, idx, self.num_classes,
            self._model_fns()[1],
        )
        return {
            f"{prefix}_loss": float(loss),
            "acc": float(acc),
            "macro_f1": float(f1),
            "precision": float(p),
            "recall": float(r),
        }

    def test(self) -> Dict[str, float]:
        out = self.evaluate(self.test_idx, prefix="test")
        out["train_time"] = self.train_time
        out["model_param"] = self.model_param
        return out

    def save(self, path: str) -> str:
        """Orbax checkpoint of the trained params + run metadata (the
        reference's checkpoint path is dead code, utils.py:244,254 —
        here it works)."""
        from textgcn.train.checkpoint import save_checkpoint

        if self.params is None:
            raise ValueError("fit() first")
        return save_checkpoint(
            path,
            self.params,
            metadata={
                "epochs_run": len(self.history),
                "seed": self.cfg.seed,
            },
        )

    def load(self, path: str) -> None:
        """Restore params from an Orbax checkpoint."""
        from textgcn.train.checkpoint import restore_checkpoint

        self.params = restore_checkpoint(path)["params"]
