"""The trainer's configuration: the JAX package's flag surface, restated.

``vfd_gan_tpu.config`` is the reference (its comments document every
field).  This module restates its ``Config`` fields, defaults, checks and
argparse front end so that the port's trainer takes the same command lines
without importing the JAX package; ``tests/test_torch_port_train.py`` pins
the two equal.  Flags that the port does not run yet parse here and are
refused by the engines (``train/engine_base.py::UNPORTED``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any

MODELS = ("mygan", "anogan", "c2plus1d", "xception", "clstm", "ganomaly")


@dataclasses.dataclass
class Config:
    ep: int = 10
    tr_plist: str = ""
    ts_plist: str = ""
    result_root: str = "results"
    isize: int = 128
    ich: int = 3
    nfr: int = 16
    batchsize: int = 4
    workers: int = 4
    model: str = "mygan"
    lr: float = 2e-5
    beta1: float = 0.5
    w_adv: float = 1.0
    w_con: float = 10.0
    pos_weight: float = 2.0
    freq: int = 50
    resume: str = ""
    ae: bool = False
    ngf: int = 32
    ndf: int = 32
    xwidth: float = 1.0
    dp: int = 0
    sp: int = 1
    tp: int = 1
    pp: int = 1
    pp_micro: int = 0
    moe_experts: int = 0
    moe_shards: int = 1
    moe_aux_w: float = 0.01
    accum: int = 1
    compute_dtype: str = "bfloat16"
    seed: int = 0
    morph_plane: str = "th"
    prefetch: int = 2
    tensorboard: bool = True
    host_flow: bool = False
    autosave_every: int = 0
    autosave_async: bool = False
    max_steps: int = 0
    flow_scale: float = 0.5
    remat: bool = False
    remat_blocks: str = ""
    cache_gt_flow: bool = False
    ref_mode_quirks: bool = False
    int8_disc: bool = False
    device_scoring: bool = False
    synthetic_data: int = 0
    synthetic_test_batches: int = 2
    synthetic_thick_masks: bool = False

    def validate(self) -> "Config":
        """The JAX ``Config.validate`` checks (vfd_gan_tpu/config.py)."""
        checks = [
            (self.model in MODELS,
             f"unknown model {self.model!r}; expected one of {MODELS}"),
            (not (self.isize % 8 or self.nfr % 8),
             "isize and nfr must be multiples of 8"),
            (not (self.model == "mygan"
                  and (self.isize < 64 or self.nfr < 16)),
             "model 'mygan' needs isize >= 64 and nfr >= 16 "
             "(64x spatial / 16x temporal downsampling)"),
            (self.compute_dtype in ("bfloat16", "float32"),
             "compute_dtype must be bfloat16 or float32"),
            (self.sp >= 1 and not (self.sp > 1 and self.nfr % self.sp),
             "sp must be >= 1 and divide nfr"),
            (self.tp >= 1, "tp must be >= 1"),
            (self.morph_plane in ("th", "hw"),
             "morph_plane must be 'th' or 'hw'"),
            (self.accum >= 1 and not self.batchsize % self.accum,
             "accum must be >= 1 and divide batchsize"),
            (not (self.accum > 1 and self.model in ("anogan", "ganomaly")),
             "--accum supports the mygan and supervised engines"),
            (self.pp >= 1 and not (self.pp > 1 and 8 % self.pp),
             "pp must be >= 1 and divide the 8 middle blocks"),
            (not (self.pp > 1 and self.model != "xception"),
             "--pp supports the xception model only"),
            (not (self.pp > 1 and (self.sp > 1 or self.tp > 1
                                   or self.accum > 1)),
             "--pp does not compose with sp/tp/accum"),
            (self.pp_micro >= 0 and not (self.pp_micro
                                         and self.batchsize % self.pp_micro),
             "pp_micro must be >= 0 and divide batchsize"),
            (self.moe_experts >= 0 and self.moe_shards >= 1,
             "moe_experts must be >= 0, moe_shards >= 1"),
            (not (self.moe_experts and self.model != "xception"),
             "--moe_experts supports the xception model only"),
            (not (self.moe_experts and self.pp > 1),
             "--moe_experts does not compose with --pp"),
            (not (self.moe_shards > 1 and (not self.moe_experts or
                                           self.moe_experts
                                           % self.moe_shards)),
             "moe_shards must divide moe_experts"),
            (not (self.ref_mode_quirks and self.accum > 1),
             "--ref_mode_quirks does not compose with --accum"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        return self

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).validate()


def build_parser() -> argparse.ArgumentParser:
    """One flag per field; booleans take ``--x`` / ``--no-x``; ``--gpu``
    is accepted for reference compatibility and ignored."""
    p = argparse.ArgumentParser(description="vfd_gan trainer (PyTorch port)")
    p.add_argument("--gpu", default="0", type=str)
    defaults = Config()
    for f in dataclasses.fields(Config):
        value = getattr(defaults, f.name)
        if isinstance(value, bool):
            p.add_argument(f"--{f.name}", default=value,
                           action=argparse.BooleanOptionalAction)
        else:
            p.add_argument(f"--{f.name}", default=value, type=type(value))
    return p


def parse_args(argv: list[str] | None = None) -> Config:
    d = vars(build_parser().parse_args(argv))
    d.pop("gpu", None)
    return Config.from_dict(d)
