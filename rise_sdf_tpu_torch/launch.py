"""Command-line launcher (counterpart of the JAX package's ``launch.py``).

    python -m rise_sdf_tpu_torch.launch --preset NAME
        (--train | --validate | --test | --predict)
        [--resume CKPT [--resume_weights_only]] [--exp_dir ./exp]
        [--gpu 0] [--device cuda|cpu] [a.b.c=value ...]

``--preset`` names a function of ``rise_sdf_tpu_torch/presets.py`` (the
port reads no YAML), where the JAX launcher takes ``--config``.  Dotlist
overrides ``a.b.c=value`` replace entries of that config; a value parses
as an int, a float, a bool, null or a list of those, else it stays a
string, and a key the config does not have raises (the few optional
keys in ``OPTIONAL_KEYS`` excepted).  ``--train`` runs ``fit`` (with
validation every ``trainer.val_check_interval`` steps and the saves of
``trainer.save_every_n_steps``) and then ``test``, which also exports
the mesh.  ``--resume`` restores the whole training state,
``--resume_weights_only`` the params, the occupancy grid and the step.
The run goes to ``exp_dir/[name]/[tag]@[timestamp]/{config,ckpt,save}``
with the parsed config in ``config/parsed.json``.  The device is CUDA
(``--gpu`` its index) and without CUDA the launcher raises, unless
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from typing import Any, Dict, List

import numpy as np

# keys the port reads with a default, which an override may add
OPTIONAL_KEYS = ("name", "tag", "seed", "trainer.save_every_n_steps",
                 "trainer.val_check_interval", "system.multi_emitter_eval")


def parse_value(raw: str) -> Any:
    """A dotlist value: int, float, bool, null, a ``[...]`` list of
    values, or else the string itself."""
    text = raw.strip()
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~", ""):
        return None
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [parse_value(x) for x in inner.split(",")] if inner else []
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text.strip("'\"")


def apply_overrides(config: Dict, dotlist: List[str]) -> Dict:
    """Set each ``a.b.c=value`` of ``dotlist`` in ``config`` (in place).
    Raises ``ValueError`` for an item without ``=`` and ``KeyError`` for
    a key the config lacks (outside ``OPTIONAL_KEYS``)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"malformed override (expected key=value): "
                             f"{item}")
        key, _, raw = item.partition("=")
        key = key.strip()
        *parents, leaf = key.split(".")
        node = config
        for part in parents:
            if not isinstance(node.get(part), dict):
                raise KeyError(f"unknown config key '{key}'")
            node = node[part]
        if leaf not in node and key not in OPTIONAL_KEYS:
            raise KeyError(f"unknown config key '{key}'")
        node[leaf] = parse_value(raw)
    return config


def _preset(name: str) -> Dict:
    from . import presets

    fn = getattr(presets, name, None)
    if name.startswith("_") or not callable(fn):
        raise SystemExit(f"unknown preset '{name}'")
    return fn()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", required=True,
                        help="a config function of rise_sdf_tpu_torch.presets")
    parser.add_argument("--gpu", default="0", help="CUDA device index")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--resume", default=None,
                        help="checkpoint to resume from")
    parser.add_argument("--resume_weights_only", action="store_true")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--train", action="store_true")
    group.add_argument("--validate", action="store_true")
    group.add_argument("--test", action="store_true")
    group.add_argument("--predict", action="store_true")
    parser.add_argument("--exp_dir", default="./exp")
    args, extras = parser.parse_known_args(argv)

    import torch

    from . import datasets, systems

    config = apply_overrides(_preset(args.preset), extras)
    config["cmd_args"] = vars(args)
    device = args.device
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        torch.cuda.set_device(int(args.gpu))

    name = config.get("name", "exp")
    tag = config.get("tag", "") or ""
    ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    trial_dir = os.path.join(args.exp_dir, name,
                             f"{tag}@{ts}" if tag else f"@{ts}")
    config["trial_dir"] = trial_dir
    save_dir = os.path.join(trial_dir, "save")
    ckpt_dir = os.path.join(trial_dir, "ckpt")
    config_dir = os.path.join(trial_dir, "config")
    for d in (save_dir, ckpt_dir, config_dir):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(config_dir, "parsed.json"), "w") as f:
        json.dump(config, f, indent=1)

    seed = int(config.get("seed", 42))
    np.random.seed(seed)
    dm = datasets.make(config["dataset"]["name"], config["dataset"])
    system = systems.make(config["system"]["name"], config, dm,
                          save_dir=save_dir, ckpt_dir=ckpt_dir,
                          device=device)
    state = system.init_state(seed)
    if args.resume:
        state = (system.load_weights_only(args.resume)
                 if args.resume_weights_only
                 else system.load_checkpoint(args.resume))

    trainer = config["trainer"]
    if args.train:
        state = system.fit(seed=seed, state=state,
                           log_every=int(trainer.get("log_every_n_steps",
                                                     100)),
                           val_every=trainer.get("val_check_interval"))
        system.test(state)
    elif args.validate:
        system.validate(state)
    elif args.test:
        system.test(state)
    else:
        light = config["model"].get("light", {})
        system.predict(state, light.get("envlight_config", {}).get(
            "hdr_filepath"))


if __name__ == "__main__":
    main()
