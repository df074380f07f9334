"""The joint model's training options on slabs at 3-D (volumes split along
D over 2 ``gloo`` ranks on the CPU, 1 x 2, B=2), against the JAX
RegistrationModel's whole-volume ``train_step`` with the same option, as
``tests/test_torch_spatial_options.py`` holds them at 2-D (its helpers and
bars), at 16^3 (netR 3 levels deep, ``check_joint_slabs``):

- bfloat16, with ``register`` (the flow head scaled to a field of about
  0.1 voxel, the premise of the bfloat16 pos_flow bar);
- FastCUT at the coin that flips (the other is the 2-D file's and the
  plain step's path): its flip is along H (JAX's axis 2 of (B, D, H, W,
  C)), an axis every slab holds whole;
- the GAN phase with netD ``n_layers`` (2 layers: ``basic`` at 16^3
  predicts an empty map, in JAX too) and ``no_antialias_up``'s transposed
  convs, in one config: netD on the gathered volume, the transposed convs
  on the slabs.

The float32 cases' gradients are held in float64, the ranks' (a float64
twin of each case) against JAX's step run in float64 (``jax.enable_x64``),
within 1e-3 of each network's max |g|; their metrics in float32 against
it, 1e-4 relative.  In float32 the gradients of the convs that feed an
instance norm cancel: at the GAN + ``no_antialias_up`` config JAX's own
float32 step is 1.6e-3 of netG's max |g| from its float64 one (the 7^3
conv's weight), and the float32 ranks 3.2e-3 from the port's float32 one
process, where the float64 ranks are 2e-13 from the float64 one process
and 1.2e-5 from JAX's float64 step: the bar measures the slabs, not
float32's conditioning (as the 2-D step's on the card is).  bfloat16
as at 2-D.  One launch of 2 ranks, in a thread beside the JAX
compiles."""

import pytest

from test_torch_spatial_options import (FASTCUT, GAN, check_bf16_register,
                                        check_loss, check_step, start)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

CFG3D = dict(ndims=3, crop_size=16, ngf=8, netG="resnet_2blocks",
             vxm_enc=(4, 4, 4), vxm_dec=(4, 4, 4, 4, 4), netF_nc=16,
             num_patches=16, int_steps=2)
# a field of about 0.1 voxel at this config (0.156 at 8e3, the gain of
# tests/test_torch_joint3d_bf16.py's config)
BF16_GAIN3D = 5e3
# case: (the options, (n_data, n_spatial), FastCUT's coin or None)
CASES = {
    "bf16_1x2": (dict(compute_dtype="bfloat16"), (1, 2), None),
    "fastcut_tails_1x2": (FASTCUT, (1, 2), True),
    "gan_n_layers_up_1x2": (dict(GAN, netD="n_layers", n_layers_D=2,
                                 no_antialias_up=True), (1, 2), None)}


@pytest.fixture(scope="module")
def setup():
    out, pool = start(CASES, {}, CFG3D, 5, BF16_GAIN3D, x64=True,
                      n_ranks=2)
    yield out
    pool.shutdown(wait=True)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_with_the_option_on_slabs_matches_jax_3d(setup, case):
    check_loss(setup, case)


@pytest.mark.parametrize("case", CASES)
def test_train_step_with_the_option_on_slabs_matches_jax_3d(setup, case):
    check_step(setup, case)


def test_bf16_register_on_slabs_matches_jax_3d(setup):
    check_bf16_register(setup, "bf16_1x2")
