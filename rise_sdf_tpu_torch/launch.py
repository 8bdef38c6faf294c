"""Command-line launcher (counterpart of the JAX package's ``launch.py``).

    python -m rise_sdf_tpu_torch.launch (--config FILE | --preset NAME)
        (--train | --validate | --test | --predict)
        [--resume CKPT [--resume_weights_only]] [--exp_dir ./exp]
        [--gpu 0] [--device cuda|cpu] [a.b.c=value ...]

``--config`` reads a YAML config as the JAX launcher does
(``config.load_config``): dotlist overrides ``a.b.c=value`` are YAML
scalars, merged in whether or not the file has the key, then every
``${...}`` is resolved; a value left ``???`` raises.  The run writes the
resolved config to ``config/parsed.yaml`` and a copy of the file to
``config/raw.yaml``.

``--preset`` names a function of ``rise_sdf_tpu_torch/presets.py``.
Dotlist overrides ``a.b.c=value`` replace entries of that config; a value parses
as an int, a float, a bool, null or a list of those, else it stays a
string, and a key the config does not have raises (the few optional
keys in ``OPTIONAL_KEYS`` excepted).  After the overrides, ``resolve``
raises for a value still ``???`` (``dataset.scene`` of the presets of
the repo's two configs, ``dataset.root_dir`` of ``neus_colmap``) and
fills ``${a.b}`` references in strings in, as the yamls' interpolation
does (``${basename:a.b}`` with the base name of the path at ``a.b``):

    python -m rise_sdf_tpu_torch.launch --preset split_mixed_occ_tensoir
        --train dataset.scene=lego  ``--train`` runs ``fit`` (with
validation every ``trainer.val_check_interval`` steps and the saves of
``trainer.save_every_n_steps``) and then ``test``, which also exports
the mesh.  ``--resume`` restores the whole training state,
``--resume_weights_only`` the params, the occupancy grid and the step.
The run goes to ``exp_dir/[name]/[tag]@[timestamp]/{config,ckpt,save}``
with a preset's parsed config in ``config/parsed.json``.  The device is CUDA
(``--gpu`` its index) and without CUDA the launcher raises, unless
``--device cpu`` asks for the CPU.

Data parallel (``parallel/sharding.py``): ``--gpu 0,1,...`` spawns one
rank per listed GPU, joined over NCCL; under torchrun
(``python -m torch.distributed.run --nproc_per_node N -m
rise_sdf_tpu_torch.launch ...``) each process joins the group from
torchrun's variables, over NCCL on CUDA (one GPU per rank, by
``LOCAL_RANK``) and over gloo with ``--device cpu``.  Rank 0 names the
trial directory and writes every file.  ``system.table_shards=N`` (the
JAX launcher's hash-table row sharding, its ``model`` mesh axis) splits
every hash table's rows over N ranks of each data index
(``parallel/sharding.py``); N must divide the ranks, and on one process
it is ignored, as the JAX launcher builds no mesh on one device:

    python -m torch.distributed.run --standalone --nproc_per_node 2 -m
        rise_sdf_tpu_torch.launch --preset tiny_neus_config --device cpu
        --train system.table_shards=2
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import socket
import sys
from typing import Any, Dict, List

import numpy as np

# keys the port reads with a default, which an override may add
OPTIONAL_KEYS = ("name", "tag", "seed", "trainer.save_every_n_steps",
                 "trainer.val_check_interval", "system.multi_emitter_eval",
                 "system.table_shards")


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


_REFERENCE = re.compile(r"\$\{(basename:)?([\w.]+)\}")


def resolve(config: Dict) -> Dict:
    """Fill every ``${a.b.c}`` in the config's strings with the value at
    ``a.b.c``, and every ``${basename:a.b.c}`` with the base name of that
    path (in place).  Raises ``ValueError`` for a value that is still
    ``???``, a mandatory one the command line must set."""
    def lookup(key):
        node = config
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"unknown config key '{key}' in a reference")
            node = node[part]
        return node

    def fill(m):
        value = str(lookup(m[2]))
        return os.path.basename(os.path.normpath(value)) if m[1] else value

    def walk(node, path):
        for k, v in node.items():
            key = f"{path}{k}"
            if isinstance(v, dict):
                walk(v, f"{key}.")
            elif v == "???":
                raise ValueError(f"missing mandatory config value: {key} "
                                 f"(set it as {key}=...)")
            elif isinstance(v, str):
                node[k] = _REFERENCE.sub(fill, v)

    walk(config, "")
    return config


def _preset(name: str) -> Dict:
    from . import presets

    fn = getattr(presets, name, None)
    if name.startswith("_") or not callable(fn):
        raise SystemExit(f"unknown preset '{name}'")
    return fn()


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--config", help="a YAML config file")
    source.add_argument("--preset",
                        help="a config function of rise_sdf_tpu_torch.presets")
    parser.add_argument("--gpu", default="0",
                        help="CUDA device index, or a comma-separated list "
                             "of them: one NCCL rank per GPU")
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
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args, extras = _parser().parse_known_args(argv)
    gpus = [int(g) for g in str(args.gpu).split(",")]
    if "WORLD_SIZE" in os.environ:  # under torchrun
        from .parallel import sharding

        sharding.initialize_distributed(
            "nccl" if args.device == "cuda" else "gloo")
        _run_rank(args, extras)
    elif args.device == "cuda" and len(gpus) > 1:
        import torch.multiprocessing

        with socket.socket() as s:  # a free port for the rendezvous
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        torch.multiprocessing.start_processes(
            _gpu_rank, args=(argv, gpus, f"tcp://localhost:{port}"),
            nprocs=len(gpus), join=True, start_method="spawn")
    else:
        run(args, extras)


def _gpu_rank(rank, argv, gpus, init_method):
    """Rank ``rank`` of a ``--gpu`` list: NCCL on ``cuda:gpus[rank]``."""
    from .parallel import sharding

    sharding.initialize_distributed("nccl", init_method, rank=rank,
                                    world_size=len(gpus),
                                    local_rank=gpus[rank])
    _run_rank(*_parser().parse_known_args(argv))


def _run_rank(args, extras):
    import torch.distributed as dist

    try:
        run(args, extras)
    finally:
        dist.destroy_process_group()


def load(args, extras) -> Dict:
    """The run's config: the YAML file of ``--config`` with the dotlist
    merged in and resolved, or the ``--preset`` with its overrides; a
    value still ``???`` raises."""
    if args.config:
        from .config import config_to_primitive, load_config

        return resolve(config_to_primitive(
            load_config(args.config, cli_args=extras)))
    return resolve(apply_overrides(_preset(args.preset), extras))


def run(args, extras):
    """One process's run: the whole run, or one rank's share of it."""
    import torch
    import torch.distributed as dist

    from . import datasets, systems
    from .parallel import sharding

    config = load(args, extras)
    # a count that does not divide the ranks raises before any file
    sharding.table_shard_count(int(config["system"].get("table_shards", 1)
                                   or 1))
    config["cmd_args"] = vars(args)
    device = args.device
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        if not dist.is_initialized():  # a rank's GPU is set as it joins
            torch.cuda.set_device(int(args.gpu))

    name = config.get("name", "exp")
    tag = config.get("tag", "") or ""
    # rank 0's clock names the trial directory of every rank
    ts = [datetime.datetime.now().strftime("%Y%m%d-%H%M%S")]
    if dist.is_initialized():
        dist.broadcast_object_list(ts, 0)
    trial_dir = os.path.join(args.exp_dir, name,
                             f"{tag}@{ts[0]}" if tag else f"@{ts[0]}")
    config["trial_dir"] = trial_dir
    save_dir = os.path.join(trial_dir, "save")
    ckpt_dir = os.path.join(trial_dir, "ckpt")
    config_dir = os.path.join(trial_dir, "config")
    if sharding.is_main_process():
        for d in (save_dir, ckpt_dir, config_dir):
            os.makedirs(d, exist_ok=True)
        if args.config:  # as the JAX launcher: parsed and raw YAML
            from .config import dump_config

            dump_config(config, os.path.join(config_dir, "parsed.yaml"))
            shutil.copy(args.config, os.path.join(config_dir, "raw.yaml"))
        else:
            with open(os.path.join(config_dir, "parsed.json"), "w") as f:
                json.dump(config, f, indent=1)

    seed = int(config.get("seed", 42))
    np.random.seed(seed)
    dm = datasets.make(config["dataset"]["name"], config["dataset"])
    system = systems.make(config["system"]["name"], config, dm,
                          save_dir=save_dir, ckpt_dir=ckpt_dir,
                          device=device)
    if dist.is_initialized() and sharding.is_main_process():
        mesh = system.mesh
        print(f"mesh over {sharding.world_size()} ranks: data={mesh.dp}"
              + (f" x model={mesh.tp}" if mesh.tp > 1 else ""), flush=True)
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
