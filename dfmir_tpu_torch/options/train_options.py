"""Training flags (the JAX package's ``options/train_options.py``).  The
display-server flags parse for compatibility; losses go to
``loss_history.jsonl`` and visuals to the HTML gallery."""

from __future__ import annotations

from dfmir_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions):
    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        # display / HTML cadence
        parser.add_argument("--display_freq", type=int, default=400)
        parser.add_argument("--display_ncols", type=int, default=4)
        parser.add_argument("--display_id", type=int, default=None)
        parser.add_argument("--display_server", type=str,
                            default="http://localhost")
        parser.add_argument("--display_env", type=str, default="main")
        parser.add_argument("--display_port", type=int, default=8097)
        parser.add_argument("--display_host", type=str, default="127.0.0.1",
                            help="dashboard bind address (unauthenticated; "
                                 "use 0.0.0.0 to allow remote access)")
        parser.add_argument("--update_html_freq", type=int, default=1000)
        parser.add_argument("--print_freq", type=int, default=100)
        parser.add_argument("--no_html", action="store_true")
        # saving / resuming
        parser.add_argument("--save_latest_freq", type=int, default=5000)
        parser.add_argument("--save_epoch_freq", type=int, default=5)
        parser.add_argument("--evaluation_freq", type=int, default=5000)
        parser.add_argument("--save_by_iter", action="store_true")
        parser.add_argument("--continue_train", action="store_true")
        parser.add_argument("--epoch_count", type=int, default=1)
        parser.add_argument("--phase", type=str, default="train")
        parser.add_argument("--pretrained_name", type=str, default=None)
        # optimization
        parser.add_argument("--n_epochs", type=int, default=150,
                            help="epochs at the initial learning rate")
        parser.add_argument("--n_epochs_decay", type=int, default=150,
                            help="epochs linearly decaying LR to zero")
        parser.add_argument("--beta1", type=float, default=0.5)
        parser.add_argument("--beta2", type=float, default=0.999)
        parser.add_argument("--lr", type=float, default=2e-4)
        parser.add_argument("--gan_mode", type=str, default="lsgan",
                            choices=["vanilla", "lsgan", "wgangp",
                                     "nonsaturating"])
        parser.add_argument("--pool_size", type=int, default=50)
        parser.add_argument("--lr_policy", type=str, default="linear",
                            choices=["linear", "step", "plateau", "cosine"])
        parser.add_argument("--lr_decay_iters", type=int, default=50)
        # observability
        parser.add_argument("--profile_dir", type=str, default=None,
                            help="write a torch.profiler trace here")
        parser.add_argument("--profile_steps", type=int, default=5,
                            help="number of steps to trace (after warmup)")
        parser.add_argument("--jac_freq", type=int, default=0,
                            help="every N iters, log scalar deformation "
                                 "health (folding %%, |J| range, max "
                                 "displacement) alongside the losses")
        self.isTrain = True
        return parser
