"""ReduceLROnPlateau (terrain_tpu/train/schedule.py; numpy only).

The reference ports this from Keras and wires it into the train loop
commented out; the trainer keeps it default-off behind `reduce_on_plateau`.
The learning rate is a plain float that the trainer passes to every step.
"""

import numpy as np


class ReduceLROnPlateau:
    """Reduce LR by `factor` after `patience` epochs without improvement."""

    def __init__(self, factor=0.1, patience=10, mode="min", epsilon=1e-4,
                 cooldown=0, min_lr=0.0, verbose=0):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support factor >= 1.0")
        self.factor = factor
        self.patience = patience
        self.mode = mode if mode in ("min", "max") else "min"
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        self.reset()

    def reset(self):
        self.cooldown_counter = 0
        self.wait = 0
        self.best = np.inf if self.mode == "min" else -np.inf
        self.lr_epsilon = self.min_lr * 1e-4

    def _improved(self, current):
        if self.mode == "min":
            return current < self.best - self.epsilon
        return current > self.best + self.epsilon

    def step(self, lr, monitor, epoch=None):
        """Feed the monitored metric; returns the (possibly reduced) lr."""
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(monitor):
            self.best = monitor
            self.wait = 0
        elif self.cooldown_counter <= 0:
            if self.wait >= self.patience:
                if lr > self.min_lr + self.lr_epsilon:
                    lr = max(lr * self.factor, self.min_lr)
                    if self.verbose:
                        print(f"epoch {epoch}: reducing learning rate to {lr}")
                    self.cooldown_counter = self.cooldown
                    self.wait = 0
            self.wait += 1
        return lr
