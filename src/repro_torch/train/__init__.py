"""Training steps + trainer (port of ``src/repro/train``)."""

from .steps import make_prefill_step, make_serve_step, make_train_step  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
