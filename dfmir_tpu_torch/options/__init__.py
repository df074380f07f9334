"""Command-line options: the JAX package's flag surface."""

from dfmir_tpu_torch.options.base_options import BaseOptions
from dfmir_tpu_torch.options.test_options import TestOptions
from dfmir_tpu_torch.options.train_options import TrainOptions

__all__ = ["BaseOptions", "TrainOptions", "TestOptions"]
