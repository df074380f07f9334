"""Training entry point (the JAX package's ``train.py``): the epoch /
iteration loop, the compute and data timing, the display / print / save
cadence and the LR step at each epoch's end.

    python -m dfmir_tpu_torch.train --dataroot DATA --name EXP [flags]

The flags are the JAX command line's (``options/``).  Each step ends in
``torch.cuda.synchronize()`` on the card, so the timings are the step's.
``--profile_dir`` writes a ``torch.profiler`` trace of ``--profile_steps``
steps after two warm-up steps.  ``main`` returns the task and the
seconds of each step (compute, and the wait for its batch).
"""

import os
import time

import torch

from dfmir_tpu_torch.data import create_dataset
from dfmir_tpu_torch.models import create_model
from dfmir_tpu_torch.options import TrainOptions
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


def main(argv=None):
    opt = TrainOptions(argv).parse()
    dataset = create_dataset(opt)
    dataset_size = len(dataset)

    model = create_model(opt)
    print(f"The number of training images = {dataset_size}")

    visualizer = Visualizer(opt)
    total_iters = 0
    optimize_time = 0.1
    t_data = 0.0
    step_s, data_s = [], []
    profile_dir = getattr(opt, "profile_dir", None)
    profile_at = 2 if profile_dir else -1  # trace after warm-up
    profiler = None

    for epoch in range(opt.epoch_count,
                       opt.n_epochs + opt.n_epochs_decay + 1):
        epoch_start_time = time.time()
        iter_data_time = time.time()
        epoch_iter = 0
        visualizer.reset()
        dataset.set_epoch(epoch)
        for i, data in enumerate(dataset):
            iter_start_time = time.time()
            data_s.append(iter_start_time - iter_data_time)
            if total_iters % opt.print_freq == 0:
                t_data = iter_start_time - iter_data_time

            batch_size = data["A"].shape[0]
            total_iters += batch_size
            epoch_iter += batch_size
            optimize_start_time = time.time()
            if epoch == opt.epoch_count and i == 0:
                model.data_dependent_initialize(data)
                model.setup(opt)
                model.parallelize()
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
                save_result = total_iters % opt.update_html_freq == 0
                model.compute_visuals()
                visualizer.display_current_results(
                    model.get_current_visuals(), epoch, save_result)

            if total_iters % opt.print_freq == 0:
                losses = model.get_current_losses()
                if opt.jac_freq > 0 and total_iters % opt.jac_freq == 0:
                    losses.update(model.registration_stats())
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
    return {"model": model, "step_s": step_s, "data_s": data_s}


if __name__ == "__main__":
    main()
