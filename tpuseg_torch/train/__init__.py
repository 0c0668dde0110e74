"""Training and eval orchestration: optimizers and schedules, the train
step, checkpoints, the ``Trainer`` and ``evaluate_only``."""
