"""INI configuration parsing with the reference's exact semantics.

Reference parity: the reference splits config across argparse flags and an
``.ini`` file with sections [training]/[optimization]/[logging]/
[hyperparameters] (upstream scripts/train.py:47-73,
upstream common/train.py:94-114, upstream scripts/eval.py:51-68).
The same files (e.g. upstream scripts/configs/mapnet.ini) parse
unchanged here:

- [optimization] values are ``json.loads``-parsed per key (so
  ``lr_stepvalues = [60, 80]`` is a list), ``opt`` is the method name;
- hyperparameter ``beta`` seeds ``saq`` (sax is fixed 0), ``gamma`` seeds
  ``srq`` (srx fixed 0) — scripts/train.py:59-67;
- PGO covariances s_abs_trans/s_abs_rot/s_rel_trans/s_rel_rot default to the
  reference's eval defaults (1, 1, 20, 20 — eval.py:65-68).

A copy of :mod:`geomapnet_tpu.cli.config`; tests/test_torch_import_isolation.py
pins it to the original.
"""

from __future__ import annotations

import configparser
import dataclasses
import json
from pathlib import Path

__all__ = ["ExperimentConfig", "parse_ini"]


@dataclasses.dataclass
class ExperimentConfig:
    # [training]
    n_epochs: int = 300
    batch_size: int = 20
    do_val: bool = True
    shuffle: bool = True
    seed: int = 7
    num_workers: int = 5
    snapshot: int = 50
    val_freq: int = 50
    max_grad_norm: float = 0.0
    # [optimization]
    opt: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 5e-4
    optim_extras: dict = dataclasses.field(default_factory=dict)
    # [logging]
    visdom: bool = False
    print_freq: int = 20
    # [hyperparameters]
    beta: float = -3.0        # initial saq
    gamma: float = -3.0       # initial srq
    dropout: float = 0.5
    color_jitter: float = 0.0
    skip: int = 10
    real: bool = False
    variable_skip: bool = False
    steps: int = 3
    vo_lib: str = "orbslam"
    s_abs_trans: float = 1.0
    s_abs_rot: float = 1.0
    s_rel_trans: float = 20.0
    s_rel_rot: float = 20.0


def parse_ini(path: str | Path) -> ExperimentConfig:
    """Parse a reference-format .ini into an :class:`ExperimentConfig`."""
    settings = configparser.ConfigParser()
    with open(path, "r") as f:
        settings.read_file(f)
    cfg = ExperimentConfig()

    tr = settings["training"]
    cfg.n_epochs = tr.getint("n_epochs", cfg.n_epochs)
    cfg.batch_size = tr.getint("batch_size", cfg.batch_size)
    cfg.do_val = tr.getboolean("do_val", cfg.do_val)
    cfg.shuffle = tr.getboolean("shuffle", cfg.shuffle)
    cfg.seed = tr.getint("seed", cfg.seed)
    cfg.num_workers = tr.getint("num_workers", cfg.num_workers)
    cfg.snapshot = tr.getint("snapshot", cfg.snapshot)
    cfg.val_freq = tr.getint("val_freq", cfg.val_freq)
    cfg.max_grad_norm = tr.getfloat("max_grad_norm", 0.0)

    if "optimization" in settings:
        opt = dict(settings["optimization"])
        # the reference leaves the method name unquoted (json.loads skips
        # it); tolerate a json-quoted spelling too
        cfg.opt = opt.pop("opt", cfg.opt).strip("\"'")
        parsed = {k: json.loads(v) for k, v in opt.items()}
        cfg.lr = parsed.pop("lr", cfg.lr)
        cfg.weight_decay = parsed.pop("weight_decay", cfg.weight_decay)
        cfg.optim_extras = parsed  # momentum, lr_decay, lr_stepvalues, ...

    if "logging" in settings:
        lg = settings["logging"]
        cfg.visdom = lg.getboolean("visdom", cfg.visdom)
        cfg.print_freq = lg.getint("print_freq", cfg.print_freq)

    hp = settings["hyperparameters"]
    cfg.beta = hp.getfloat("beta", cfg.beta)
    cfg.gamma = hp.getfloat("gamma", cfg.gamma)
    cfg.dropout = hp.getfloat("dropout", cfg.dropout)
    cfg.color_jitter = hp.getfloat("color_jitter", 0.0)
    cfg.skip = hp.getint("skip", cfg.skip)
    cfg.real = hp.getboolean("real", cfg.real)
    cfg.variable_skip = hp.getboolean("variable_skip", cfg.variable_skip)
    cfg.steps = hp.getint("steps", cfg.steps)
    cfg.vo_lib = hp.get("vo_lib", cfg.vo_lib)
    cfg.s_abs_trans = hp.getfloat("s_abs_trans", 1.0)
    cfg.s_abs_rot = hp.getfloat("s_abs_rot", 1.0)
    cfg.s_rel_trans = hp.getfloat("s_rel_trans", 20.0)
    cfg.s_rel_rot = hp.getfloat("s_rel_rot", 20.0)
    return cfg
