from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.train_step import loss_and_grads, make_train_step

__all__ = ["AdamW", "AdamWConfig", "loss_and_grads", "make_train_step"]
