"""The 3-D zoo in the joint model, case strided: netF strided_conv (its
specs from each tap's D, its rows every location of a 3-D map, channels
last; taps 4-16, ``STRIDED_LAYERS``) and netD pixel, against the JAX
model (``test_torch_zoo3d_train.py`` holds the setup and the bars)."""

import pytest

from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo3d_train import (check_launches, check_register,
                                    make_case3d)
from test_torch_zoo_train import check_loss_fn, check_train_step
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def case():
    return make_case3d("strided")


def test_register_matches_jax(case):
    check_register(case)


def test_loss_fn_matches_jax(case):
    tm = case["port_model"]()
    assert tm.netF.conv_0_out.weight.ndim == 5
    assert all(getattr(tm.netF, f"ema_{i}").ndim == 4
               for i in range(len(tm.netF.specs)))
    check_loss_fn(case)


def test_train_step_matches_jax(case):
    check_train_step(case)


def test_launches_3d_zoo(case, counted_kernels):
    check_launches(case, counted_kernels)
