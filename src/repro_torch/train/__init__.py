from repro_torch.train.train_step import make_train_step, make_eval_step, TrainStepConfig  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
