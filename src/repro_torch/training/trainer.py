"""Trainer — counterpart of ``repro/training/trainer.py``: the paper's
training loop for MeshNet.

One step, in the reference's order: the training forward with BatchNorm
statistics (``meshnet.apply_with_stats``), CE + soft Dice with the hard
Dice metric (``losses.segmentation_loss``, one K3 launch on the card),
the backward, ``adamw_update`` over the whole params tree, then the
batch's BatchNorm statistics folded into ``bn_mean``/``bn_var`` with
``bn_momentum``. ``evaluate`` segments held-out synthetic subjects
through the executor registry's ``auto`` (K1 on the card) and scores each
with K3. PyTorch runs eagerly, so there is no jit; the step keeps its
metrics on the device and never waits for it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.core import executors, meshnet
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.data import mri
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import losses
from repro_torch.training import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: MeshNetConfig = dataclasses.field(default_factory=MeshNetConfig)
    data: mri.DataLoaderConfig = dataclasses.field(default_factory=mri.DataLoaderConfig)
    opt: opt_mod.AdamWConfig = dataclasses.field(default_factory=opt_mod.AdamWConfig)
    steps: int = 300
    dice_weight: float = 1.0
    bn_momentum: float = 0.1
    eval_subjects: int = 4
    log_every: int = 25
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    seed: int = 0


def forward_loss(params, vol: torch.Tensor, lab: torch.Tensor, cfg: TrainConfig,
                 generator: Optional[torch.Generator] = None):
    """Training forward and loss -> (loss, metrics, stats); ``stats`` the
    per-layer batch (mean, var), still attached to the graph."""
    logits, stats = meshnet.apply_with_stats(params, vol, cfg.model, generator=generator)
    loss, metrics = losses.segmentation_loss(logits, lab, cfg.model.num_classes, cfg.dice_weight)
    return loss, metrics, stats


def loss_and_grads(params, vol: torch.Tensor, lab: torch.Tensor, cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None):
    """Forward, loss and backward -> (loss, metrics, stats, grads): grads a
    tree like ``params``, zero for the leaves the loss does not use (the
    BatchNorm running statistics); stats detached. The backward runs with
    TF32 off, as the forward does."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with meshnet.fp32_convs():
        loss, metrics, stats = forward_loss(tree.unflatten(params, leaves), vol, lab, cfg, generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    stats = [None if st is None else (st[0].detach(), st[1].detach()) for st in stats]
    return loss.detach(), metrics, stats, tree.unflatten(params, grads)


def fold_bn_stats(params, stats, cfg: TrainConfig):
    """Fold the batch's BatchNorm statistics into the running estimates:
    ``running = (1 - m) * running + m * batch``."""
    if not cfg.model.use_batchnorm:
        return params
    m = cfg.bn_momentum
    layers = []
    for layer, st in zip(params["layers"], stats):
        if st is not None:
            mean, var = st
            layer = dict(
                layer,
                bn_mean=(1 - m) * layer["bn_mean"] + m * mean,
                bn_var=(1 - m) * layer["bn_var"] + m * var,
            )
        layers.append(layer)
    return dict(params, layers=layers)


def apply_update(params, opt_state, grads, stats, cfg: TrainConfig):
    """AdamW over the whole tree, then the BatchNorm fold ->
    (params, opt_state, optimizer metrics)."""
    params, opt_state, opt_metrics = opt_mod.adamw_update(grads, opt_state, params, cfg.opt)
    return fold_bn_stats(params, stats, cfg), opt_state, opt_metrics


def make_train_step(cfg: TrainConfig) -> Callable:
    """The train step: (params, opt_state, vol, lab, generator=None) ->
    (params, opt_state, metrics); ``generator`` draws the dropout masks."""

    def train_step(params, opt_state, vol, lab, generator: Optional[torch.Generator] = None):
        loss, metrics, stats, grads = loss_and_grads(params, vol, lab, cfg, generator)
        params, opt_state, opt_metrics = apply_update(params, opt_state, grads, stats, cfg)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def evaluate(params, cfg: TrainConfig, num_subjects: Optional[int] = None, seed: int = 10_000) -> float:
    """Mean macro Dice over held-out synthetic subjects, on the device of
    ``params``: each subject segmented through the executor ``auto``
    (K1 on the card, the plain forward on the CPU), argmax, and scored
    with ``losses.dice_score`` (K3 on the card)."""
    n = num_subjects or cfg.eval_subjects
    dev = tree.leaves(params)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    dices = []
    with torch.no_grad():
        for _ in range(n):
            vol, lab = mri.generate(gen, cfg.data.mri, device=dev)
            pred = torch.argmax(executors.apply("auto", params, vol[None], cfg.model), dim=-1)[0]
            dices.append(float(losses.dice_score(pred, lab, cfg.model.num_classes)))
    return sum(dices) / len(dices)


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    history: list
    final_dice: float


def train(cfg: TrainConfig, *, verbose: bool = True, init_params=None, device=None) -> TrainResult:
    """Train ``cfg.model`` for ``cfg.steps`` steps on ``device`` (None: the
    card), checkpointing every ``ckpt_every`` steps when ``ckpt_dir`` is
    set, then ``evaluate``. Init draws from a CPU generator seeded with
    ``cfg.seed``; dropout from one on ``device`` seeded with ``cfg.seed``;
    batches from the loader's own."""
    dev = resolve_device(device)
    params = (
        init_params
        if init_params is not None
        else meshnet.init(cfg.model, generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    )
    opt_state = opt_mod.adamw_init(params, cfg.opt)
    dropout_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    step_fn = make_train_step(cfg)
    loader = iter(mri.DataLoader(cfg.data, device=dev))
    history = []
    t0 = time.perf_counter()
    for step in range(1, cfg.steps + 1):
        vol, lab = next(loader)
        params, opt_state, metrics = step_fn(params, opt_state, vol, lab, dropout_gen)
        if step % cfg.log_every == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if verbose:
                print(
                    f"step {step:5d}  loss {m['loss']:.4f}  dice {m['dice']:.4f}  "
                    f"ce {m['ce']:.4f}  ({m['wall_s']:.1f}s)"
                )
        if cfg.ckpt_dir and step % cfg.ckpt_every == 0:
            ckpt_mod.save(
                f"{cfg.ckpt_dir}/step_{step:06d}",
                {"params": params, "opt_state": opt_state},
                step=step,
            )
    final_dice = evaluate(params, cfg)
    if verbose:
        print(f"final held-out macro dice: {final_dice:.4f}")
    return TrainResult(params=params, opt_state=opt_state, history=history, final_dice=final_dice)
