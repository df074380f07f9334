"""Training entry point (the JAX package's ``train.py``): the epoch /
iteration loop, the compute and data timing, the display / print / save
cadence and the LR step at each epoch's end.

    python -m dfmir_tpu_torch.train --dataroot DATA --name EXP [flags]

The flags are the JAX command line's (``options/``).  Each step ends in
``torch.cuda.synchronize()`` on the card, so the timings are the step's.
``--profile_dir`` writes a ``torch.profiler`` trace of ``--profile_steps``
steps after two warm-up steps.  ``main`` returns the task, the
seconds of each step (compute, and the wait for its batch) and the
``Visualizer``, whose live dashboard (``--display_id 1``) serves until
``close()`` or the process's end.

With more than one card in ``--gpu_ids`` (and a ``--batch_size`` that
divides over them, ``options``) ``main`` starts one process a card
(``parallel/launch.py``, NCCL) and each trains on its slice of every
global batch.  The counters, and so the print, display and save
cadences, go by the global batch, as in one process.  Rank 0 prints,
writes the loss log, the HTML and the checkpoints, and traces with
``--profile_dir``; every rank computes the printed losses (and
``--jac_freq``'s statistics) of the global batch, and the visuals of its
slice.  ``main`` then returns rank 0's step seconds and each rank's final
weights, kernel launches and peak memory, in place of the task.
"""

import contextlib
import io
import os
import time

import torch

from dfmir_tpu_torch.data import create_dataset
from dfmir_tpu_torch.device import float32_math
from dfmir_tpu_torch.models import create_model
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.options import TrainOptions
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.utils.visualizer import Visualizer


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def main(argv=None, devices=None, timeout=None):
    """Train from the command line ``argv``.  ``devices`` and ``timeout``
    are not flags (the tests and ``chip_smoke.py`` pass them): the ranks'
    devices in place of ``--gpu_ids``'s (the backend follows from them,
    ``launch.backend_for``: NCCL for distinct cards, gloo for ranks that
    share one or run on the CPU) and the launch's time limit in
    seconds."""
    float32_math()
    opt = TrainOptions(argv).parse()
    devices = [str(d) for d in (devices or opt.devices)]
    if len(devices) == 1:
        opt.device = devices[0]
        return train(opt)
    ranks = launch(_train_rank, devices, args=(opt,), timeout=timeout)
    return {"step_s": ranks[0]["step_s"], "data_s": ranks[0]["data_s"],
            "ranks": ranks}


def _train_rank(mesh, opt):
    """One rank of a data-parallel run: ``train`` on ``mesh.device``,
    silent but on rank 0; its step seconds, final weights (on the host),
    kernel launches and peak memory."""
    opt.device = str(mesh.device)
    out = contextlib.nullcontext() if mesh.rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with out:
        result = train(opt, mesh)
    model = result["model"]
    weights = {name: {k: v.detach().cpu() for k, v in net.state_dict().items()}
               for name, net in model._nets().items()
               if name in model.model_names}
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else None)
    return {"step_s": result["step_s"], "data_s": result["data_s"],
            "weights": weights, "launches": dict(warp_cuda.LAUNCHES),
            "peak_bytes": peak}


def train(opt, mesh=None):
    """The training loop, in one process or as rank ``mesh.rank``."""
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    lead = rank == 0
    dataset = create_dataset(opt, rank, world)
    dataset_size = len(dataset)

    model = create_model(opt)
    print(f"The number of training images = {dataset_size}")

    visualizer = Visualizer(opt) if lead else None
    total_iters = 0
    optimize_time = 0.1
    t_data = 0.0
    step_s, data_s = [], []
    profile_dir = getattr(opt, "profile_dir", None)
    profile_at = 2 if profile_dir and lead else -1  # trace after warm-up
    profiler = None

    for epoch in range(opt.epoch_count,
                       opt.n_epochs + opt.n_epochs_decay + 1):
        epoch_start_time = time.time()
        iter_data_time = time.time()
        epoch_iter = 0
        if lead:
            visualizer.reset()
        dataset.set_epoch(epoch)
        for i, data in enumerate(dataset):
            iter_start_time = time.time()
            data_s.append(iter_start_time - iter_data_time)
            if total_iters % opt.print_freq == 0:
                t_data = iter_start_time - iter_data_time

            batch_size = data["A"].shape[0] * world      # the global batch
            total_iters += batch_size
            epoch_iter += batch_size
            optimize_start_time = time.time()
            if epoch == opt.epoch_count and i == 0:
                model.data_dependent_initialize(data)
                model.setup(opt)
                model.parallelize(mesh)
            if i == profile_at and profiler is None:
                profiler = _start_profiler(model.device)
            model.set_input(data)
            model.optimize_parameters()
            _sync(model.device)
            if profiler is not None and \
                    i >= profile_at + opt.profile_steps - 1:
                profiler.stop()
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(profile_dir, "trace.json"))
                profiler = None
                profile_at = -1
                print(f"profiler trace written to {profile_dir}")
            step_s.append(time.time() - optimize_start_time)
            optimize_time = (step_s[-1] / batch_size * 0.005
                             + 0.995 * optimize_time)

            if total_iters % opt.display_freq == 0:
                # on every rank: the visuals' loss draws patch ids from the
                # model's generator, which the ranks keep in step
                model.compute_visuals()
                if lead:
                    save_result = total_iters % opt.update_html_freq == 0
                    visualizer.display_current_results(
                        model.get_current_visuals(), epoch, save_result)

            if total_iters % opt.print_freq == 0:
                losses = model.get_current_losses()
                if opt.jac_freq > 0 and total_iters % opt.jac_freq == 0:
                    losses.update(model.registration_stats())
                if lead:
                    visualizer.print_current_losses(
                        epoch, epoch_iter, losses, optimize_time, t_data)
                    if opt.display_id is None or opt.display_id > 0:
                        visualizer.plot_current_losses(
                            epoch, float(epoch_iter) / dataset_size, losses)

            if total_iters % opt.save_latest_freq == 0:
                print(f"saving the latest model (epoch {epoch}, "
                      f"total_iters {total_iters})")
                print(opt.name)
                suffix = (f"iter_{total_iters}" if opt.save_by_iter
                          else "latest")
                model.save_networks(suffix)

            iter_data_time = time.time()

        if epoch % opt.save_epoch_freq == 0:
            print(f"saving the model at the end of epoch {epoch}, "
                  f"iters {total_iters}")
            model.save_networks("latest")
            model.save_networks(epoch)
        print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay}"
              f" \t Time Taken: {int(time.time() - epoch_start_time)} sec")
        model.update_learning_rate()
    if profiler is not None:
        profiler.stop()
    return {"model": model, "step_s": step_s, "data_s": data_s,
            "visualizer": visualizer}


if __name__ == "__main__":
    main()
