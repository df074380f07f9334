"""Training observability (the JAX package's ``utils/visualizer.py``):
console + ``loss_log.txt``, one ``loss_history.jsonl`` record per print,
and the HTML gallery under ``{checkpoints_dir}/{name}/web``.  With
``--display_id > 0`` the live dashboard (``utils/plot_server.py``) serves
those files on ``--display_host``:``--display_port`` while training runs."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from dfmir_tpu_torch.utils import html as html_mod
from dfmir_tpu_torch.utils.plot_server import start_plot_server
from dfmir_tpu_torch.utils.util import mkdirs, save_image, tensor2im


def save_images(webpage, visuals: Dict, image_path, aspect_ratio=1.0,
                width=256) -> None:
    """Save visuals (NCHW, first item) to the webpage's image dir as
    ``{name}_{label}.png`` and add a gallery row."""
    image_dir = webpage.get_image_dir()
    short_path = os.path.basename(
        image_path[0] if isinstance(image_path, (list, tuple))
        else image_path)
    name = os.path.splitext(short_path)[0]
    webpage.add_header(name)
    ims, txts, links = [], [], []
    for label, im_data in visuals.items():
        im = tensor2im(im_data)
        image_name = f"{name}_{label}.png"
        save_image(im, os.path.join(image_dir, image_name),
                   aspect_ratio=aspect_ratio)
        ims.append(image_name)
        txts.append(label)
        links.append(image_name)
    webpage.add_images(ims, txts, links, width=width)


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.use_html = getattr(opt, "isTrain", False) and \
            not getattr(opt, "no_html", False)
        self.win_size = getattr(opt, "display_winsize", 256)
        self.saved = False
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        mkdirs(expr_dir)
        if self.use_html:
            self.web_dir = os.path.join(expr_dir, "web")
            self.img_dir = os.path.join(self.web_dir, "images")
            print(f"create web directory {self.web_dir}...")
            mkdirs([self.web_dir, self.img_dir])
        self.log_name = os.path.join(expr_dir, "loss_log.txt")
        self.jsonl_name = os.path.join(expr_dir, "loss_history.jsonl")
        self.plot_server = None
        display_id = getattr(opt, "display_id", None)
        if display_id is not None and display_id > 0:
            self.plot_server = start_plot_server(
                expr_dir, opt.name,
                port=getattr(opt, "display_port", 8097),
                host=getattr(opt, "display_host", "127.0.0.1"),
                winsize=self.win_size)
        with open(self.log_name, "a") as f:
            now = time.strftime("%c")
            f.write(
                f"================ Training Loss ({now}) ================\n")

    def reset(self) -> None:
        self.saved = False

    def close(self) -> None:
        """Stop the live dashboard, if one serves (a process that ends
        stops it too: its thread is a daemon)."""
        if self.plot_server is not None:
            server, thread = self.plot_server
            server.shutdown()
            server.server_close()
            thread.join()
            self.plot_server = None

    def display_current_results(self, visuals: Dict, epoch: int,
                                save_result: bool) -> None:
        """Save the current visuals as epochNNN_<label>.png and rebuild the
        HTML index."""
        if not self.use_html or not (save_result or not self.saved):
            return
        self.saved = True
        for label, image in visuals.items():
            save_image(tensor2im(image), os.path.join(
                self.img_dir, f"epoch{epoch:03d}_{label}.png"))
        webpage = html_mod.HTML(
            self.web_dir, f"Experiment name = {self.name}", refresh=0)
        for n in range(epoch, 0, -1):
            webpage.add_header(f"epoch [{n}]")
            ims, txts, links = [], [], []
            for label in visuals:
                img_name = f"epoch{n:03d}_{label}.png"
                if os.path.exists(os.path.join(self.img_dir, img_name)):
                    ims.append(img_name)
                    txts.append(label)
                    links.append(img_name)
            if ims:
                webpage.add_images(ims, txts, links, width=self.win_size)
        webpage.save()

    def plot_current_losses(self, epoch: int, counter_ratio: float,
                            losses: Dict[str, float]) -> None:
        """Append one JSONL record of the losses."""
        rec = {"epoch": epoch, "counter_ratio": counter_ratio,
               "losses": {k: float(v) for k, v in losses.items()}}
        with open(self.jsonl_name, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def print_current_losses(self, epoch: int, iters: int,
                             losses: Dict[str, float],
                             t_comp: float, t_data: float) -> None:
        message = (f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, "
                   f"data: {t_data:.3f}) ")
        for k, v in losses.items():
            message += f"{k}: {float(v):.3f} "
        print(message)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")
