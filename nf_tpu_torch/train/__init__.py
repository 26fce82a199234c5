from .checkpoint import load_checkpoint, save_checkpoint, train_state_tree  # noqa: F401
from .trainer import RMSprop, Trainer, TrainState, lr_schedule, make_optimizer  # noqa: F401
