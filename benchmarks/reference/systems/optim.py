"""Adam or AdamW with per-group learning rates and the LR schedule
(counterpart of ``rise_sdf_tpu/systems/optim.py``).

``make_lr_lambda`` reproduces ``make_lr_schedule``: a factor as a
function of the update count, which ``torch.optim.lr_scheduler.LambdaLR``
applies to every group's base lr.  torch's SequentialLR restarts each
scheduler at its milestone; so does this.  ChainedScheduler multiplies
its schedules, each at the same count.

The JAX optimizer is one optax chain over the whole params tree:
``scale_by_adam``, for AdamW ``add_decayed_weights(wd)``, the group lr,
the schedule.  Its decay step is ``lr_group * schedule * wd * p``, which
is what ``torch.optim.AdamW`` applies.  A leaf of that tree that is not
trained (the variance's ``prev_inv_s``, a persistent buffer here) still
goes through the chain: a zero gradient leaves Adam's moments at zero
and its update at zero, but AdamW decays it.  So the groups hold the
model's persistent buffers beside its parameters (``model_leaves``),
and the system gives them zero gradients, as it does every parameter
off the step's graph.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def make_lr_lambda(config) -> Callable[[int], float]:
    """system.scheduler -> callable(step) -> multiplicative factor."""
    sched = config.get("scheduler", None)
    if sched is None:
        return lambda step: 1.0
    name = sched["name"]
    if name == "SequentialLR":
        milestones = [int(m) for m in sched["milestones"]]
        subs = [make_lr_lambda({"scheduler": s}) for s in sched["schedulers"]]

        def fn(step):
            out = subs[0](step)
            for ms, sub in zip(milestones, subs[1:]):
                if step >= ms:
                    out = sub(step - ms)
            return out

        return fn
    if name == "LinearLR":
        args = sched["args"]
        start = float(args.get("start_factor", 1.0 / 3))
        end = float(args.get("end_factor", 1.0))
        total = int(args.get("total_iters", 5))
        return lambda step: start + (end - start) * min(max(step / total,
                                                            0.0), 1.0)
    if name == "ExponentialLR":
        gamma = float(sched["args"]["gamma"])
        return lambda step: gamma ** step
    if name == "ChainedScheduler":
        subs = [make_lr_lambda({"scheduler": s}) for s in sched["schedulers"]]

        def chained(step):
            out = 1.0
            for sub in subs:
                out = out * sub(step)
            return out

        return chained
    if name == "ConstantLR":
        args = sched["args"]
        factor = float(args.get("factor", 1.0 / 3))
        total = int(args.get("total_iters", 5))
        return lambda step: factor if step < total else 1.0
    raise ValueError(f"Unknown scheduler '{name}'")


def model_leaves(module: torch.nn.Module):
    """The leaves of ``module``'s JAX params subtree: its parameters that
    take gradients and its persistent buffers (state the JAX package
    keeps in ``params``, such as the variance's ``prev_inv_s``)."""
    params = [p for p in module.parameters() if p.requires_grad]
    buffers = [t for t in module.state_dict(keep_vars=True).values()
               if not isinstance(t, torch.nn.Parameter)]
    return params + buffers


def make_optimizer(config, model: torch.nn.Module):
    """system.optimizer (+ scheduler) -> (Adam or AdamW, LambdaLR).

    ``config.optimizer.params.<group>.lr`` sets the lr of the leaves
    under the model's top-level child ``<group>`` (geometry / texture /
    variance); other children take the base lr.  AdamW's
    ``weight_decay`` defaults to 1e-2, as in JAX.
    """
    opt = config["optimizer"]
    args = opt.get("args", {})
    base_lr = float(args.get("lr", 1e-3))
    betas = args.get("betas", [0.9, 0.999])
    name = opt.get("name", "Adam")
    if name not in ("Adam", "AdamW", "FusedAdam"):
        raise ValueError(f"Unknown optimizer '{name}'")
    group_lrs: Dict[str, float] = {
        g: float(sub.get("lr", base_lr))
        for g, sub in opt.get("params", {}).items()}
    groups = []
    for child, module in model.named_children():
        leaves = model_leaves(module)
        if leaves:
            groups.append({"params": leaves, "name": child,
                           "lr": group_lrs.get(child, base_lr)})
    kw = {"lr": base_lr, "betas": (float(betas[0]), float(betas[1])),
          "eps": float(args.get("eps", 1e-8))}
    if name == "AdamW":
        optimizer = torch.optim.AdamW(
            groups, weight_decay=float(args.get("weight_decay", 1e-2)), **kw)
    else:
        optimizer = torch.optim.Adam(groups, **kw)
    sched = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                              make_lr_lambda(config))
    return optimizer, sched
