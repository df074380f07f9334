"""The port's ``--model vxm`` task against the JAX package's at mse and
with --bidir (at NCC, the default loss): three steps each from the same
weights, losses within 1e-4 relative and parameters within atol 1e-5 /
rtol 1e-4 (but for Adam's sign artefacts), as test_torch_vxm_task.py
holds the NCC task (whose helpers
this file shares; its own file, so that the suite's workers compile the
JAX steps side by side)."""

import pytest

from test_torch_vxm_task import (batches, check_steps, few_threads,  # noqa: F401
                                 paired_tasks, run_jax)

CONFIGS = {"mse": ["--image_loss", "mse"], "bidir": ["--bidir"]}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_steps_match_jax(tmp_path, config):
    mine, ref = paired_tasks(tmp_path, config, CONFIGS[config])
    assert mine.cfg.bidir == (config == "bidir")
    assert mine.cfg.image_loss == ("mse" if config == "mse" else "ncc")
    steps = batches(2)
    run = run_jax(ref, steps)
    assert run["losses"][0]["smooth"] > 0            # the field deforms
    check_steps(mine, run, steps)
