"""The StyleGAN2 cases of ``test_torch_zoo_train.py`` (its docstring
gives the bars): netG stylegan2 with netF reshape, netR vxm_dual and netD
patchstylegan2; netG smallstylegan2 with netF strided_conv and netD
tilestylegan2.  A file of their own, so that the suite's workers share
the JAX compiles."""

import pytest

from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_zoo_train import check_loss_fn, check_train_step, make_case


@pytest.fixture(scope="module", params=["stylegan2", "small"])
def case(request):
    return make_case(request.param)


def test_loss_fn_matches_jax(case):
    check_loss_fn(case)


def test_train_step_matches_jax(case):
    check_train_step(case)
