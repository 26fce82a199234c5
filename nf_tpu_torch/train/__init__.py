from .trainer import RMSprop, Trainer, TrainState, lr_schedule, make_optimizer  # noqa: F401
