from textgcn.train.metrics import accuracy, macro_f1  # noqa: F401
from textgcn.train.trainer import Trainer, TrainConfig  # noqa: F401
