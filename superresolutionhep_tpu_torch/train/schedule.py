"""Per-epoch learning-rate schedule: cosine warmup -> cosine anneal -> floor.

A copy of the JAX package's ``train/schedule.py`` (pure Python), value for
value: the reference's custom scheduler including the fractional-epoch
resolution against ``max_epoch``, as a pure function epoch -> lr that the
trainer reads once per epoch.
"""

from __future__ import annotations

import math


def resolve_epochs(value: float, max_epoch: int | None) -> int:
    if value and 0 < value < 1:
        if max_epoch is None:
            raise ValueError("max_epoch required for fractional schedule arguments")
        return int(value * max_epoch)
    return int(value)


def warmup_cosine_epoch_schedule(
    base_lr: float,
    warm_start_epochs: float,
    cosine_epochs: float,
    eta_min: float = 0.0,
    max_epoch: int | None = None,
):
    """Returns f(epoch:int) -> lr."""
    warm = resolve_epochs(warm_start_epochs, max_epoch)
    cos = resolve_epochs(cosine_epochs, max_epoch)

    def lr(epoch: int) -> float:
        if epoch < warm:
            return eta_min + (base_lr - eta_min) * (1 - math.cos(math.pi * epoch / warm)) / 2
        if epoch < warm + cos:
            return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * (epoch - warm) / cos)) / 2
        return eta_min

    return lr


def schedule_from_config(config_t: dict):
    """Build from the reference train-config block (lightning.py:169-188).

    Returns f(epoch)->lr; constant lr when ``lr_scheduler`` is null.
    """
    base_lr = float(config_t["learningrate"])
    sched_cfg = config_t.get("lr_scheduler")
    if sched_cfg is None:
        return lambda epoch: base_lr
    max_epoch = None
    if sched_cfg.get("max_epochs") == "take_as_num_epochs":
        max_epoch = int(config_t["num_epochs"])
    return warmup_cosine_epoch_schedule(
        base_lr,
        sched_cfg["warm_start_epochs"],
        sched_cfg["cosine_epochs"],
        float(sched_cfg.get("eta_min", 0.0)),
        max_epoch,
    )
