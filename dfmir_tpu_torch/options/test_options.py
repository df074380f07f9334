"""Inference flags (the JAX package's ``options/test_options.py``)."""

from __future__ import annotations

from dfmir_tpu_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions):
    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument("--results_dir", type=str, default="./results/")
        parser.add_argument("--phase", type=str, default="test")
        parser.add_argument("--eval", action="store_true")
        parser.add_argument("--num_test", type=int, default=3000)
        # avoid cropping: load_size == crop_size
        parser.set_defaults(load_size=parser.get_default("crop_size"))
        self.isTrain = False
        return parser
