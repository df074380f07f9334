"""The netD cases of ``test_torch_zoo_bf16.py`` (its docstring gives the
bars): bfloat16 with the StyleGAN2 netDs (stylegan2, patchstylegan2,
tilestylegan2), against the JAX package's bfloat16 ``register`` and
``loss_fn``, and both netDs on JAX's bfloat16 fake_B and real_B.  A file
of their own, which the suite's workers run beside the other choices'."""

import pytest

from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo_bf16 import (CHOICES, check_loss_fn, check_register,
                                 check_step, make_case)


@pytest.fixture(scope="module", params=[k for k in CHOICES
                                        if k.startswith("netD")])
def case(request):
    return make_case(request.param)


def test_register_matches_jax_bf16(case):
    check_register(case)


def test_loss_fn_matches_jax_bf16(case):
    check_loss_fn(case)


def test_step_keeps_float32_state(case, counted_kernels):  # noqa: F811
    check_step(case, counted_kernels)
