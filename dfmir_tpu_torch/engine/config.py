"""Engine configuration: the subset of the reference's options that affects
computation (a copy of ``dfmir_tpu/engine/config.py``'s fields)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    # model / generator (reference options/base_options.py:31-47)
    input_nc: int = 1
    output_nc: int = 1
    ngf: int = 64
    netG: str = "resnet_9blocks"
    normG: str = "instance"
    no_dropout: bool = True
    init_type: str = "xavier"
    init_gain: float = 0.02
    no_antialias: bool = False
    no_antialias_up: bool = False
    # CUT flags (reference models/registration_model.py:35-71)
    netF: str = "mlp_sample"
    netF_nc: int = 256
    nce_T: float = 0.07
    num_patches: int = 256
    nce_layers: Tuple[int, ...] = (0, 4, 8, 12, 16)
    nce_idt: bool = True
    lambda_NCE: float = 0.25
    lambda_GAN: float = 0.0
    nce_includes_all_negatives_from_minibatch: bool = False
    flip_equivariance: bool = False
    gan_mode: str = "lsgan"
    # discriminator (only built when lambda_GAN > 0)
    netD: str = "basic"
    ndf: int = 64
    n_layers_D: int = 3
    normD: str = "instance"
    stylegan2_G_num_downsampling: int = 1
    # registration net: 'vxm' (paper default) | 'vxm_transformer' | 'vxm_dual'
    netR: str = "vxm"
    vxm_enc: Tuple[int, ...] = (16, 32, 32, 64, 64, 64)
    vxm_dec: Tuple[int, ...] = (64, 64, 64, 32, 32, 32, 16)
    int_steps: int = 7
    int_downsize: int = 2
    # loss weights (registration_model.py:163-166)
    smooth_weight: float = 0.20
    local_weight: float = 0.25
    # data / optimizer
    ndims: int = 2
    crop_size: int = 256
    batch_size: int = 1
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    fuse_nce_encodes: bool = True
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    @property
    def n_blocks(self) -> int:
        return {"resnet_9blocks": 9, "resnet_6blocks": 6,
                "resnet_4blocks": 4}.get(self.netG, 9)

    @classmethod
    def from_opt(cls, opt) -> "RegistrationConfig":
        """The config of parsed command-line options: every option named
        like a field, and ``--nce_layers`` as a tuple of ints."""
        nce_layers = tuple(int(i) for i in str(opt.nce_layers).split(","))
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in vars(opt).items() if k in fields}
        kwargs["nce_layers"] = nce_layers
        return cls(**kwargs)
