"""Training steps (one device; meshes come with the parallelism slice)."""

from .strategies import TrainStep, make_train_step

__all__ = ["TrainStep", "make_train_step"]
