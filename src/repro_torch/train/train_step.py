"""The train step: loss → backward → AdamW with the cosine lr (the port
of `repro.train.train_step`).

The state is ``{"params": the model (an `nn.Module`), "opt": {"mu",
"nu": fp32 moments keyed by parameter name, "count"}, "step"}``, with
`count` and `step` 0-d int32 tensors on the CPU.  The step updates it in
place and returns it, where the reference returns a new tree: at full
width a second copy of the state would not fit beside the first.  The
fault verbs are unaffected: `dist.fault.guarded_step` raises an injected
fault before the step runs, so a replayed or skipped step starts from an
untouched state, as in the reference.

The forward is the training one (`lm_loss` or `encdec_loss`), whose
attention and SSD `rcfg.kernels` chooses: "xla", the plain PyTorch
versions, is what the reference's launcher trains with; "pallas" raises,
since no kernel has a backward.  The state keeps fp32 leaves whatever
`rcfg.dtype` says, as the reference's `init_train_state` does (its
`param_dtype` is read nowhere, here or there): under the reference's
default `dtype="bfloat16"` every product casts its fp32 master weight to
bf16 at use, autograd takes the gradient back through the cast to fp32,
and AdamW updates the fp32 leaves.  Remat recomputes the same casts.

On a mesh: `distribute_train_state` puts the parameters and moments on
a `DeviceMesh` as DTensors with the rule table's placements
(`dist.sharding`), `dist.sharding.distribute_batch` splits the batch
over the data dims, and the same step runs on them: DTensor dispatch
inserts the collectives, the tensors a forward makes (masks, positions)
count as replicated, and AdamW updates each leaf's local shard.

Gradient accumulation: ``rcfg.microbatch`` > 1 splits the batch into as
many microbatches, run one after another, their gradients summed into
`.grad` and divided by their number, as the reference's scan does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import EncDec, LM, encdec_loss, lm_loss
from repro_torch.models.common import DTYPES
from repro_torch.models.ssm import SSM
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule

TrainState = Dict[str, Any]     # {"params", "opt", "step"}


def loss_fn_for(cfg: ArchConfig) -> Callable:
    if cfg.family == "audio":
        return encdec_loss
    return lm_loss


def init_fn_for(cfg: ArchConfig) -> Callable:
    """The model's class: `EncDec` for the audio family, else `LM`."""
    if cfg.family == "audio":
        return EncDec
    return LM


def check_train_dtype(rcfg: RunConfig) -> None:
    """A compute dtype neither package has raises (the reference's are
    "bfloat16" and "float32")."""
    if rcfg.dtype not in DTYPES:
        raise ValueError(f"unknown compute dtype {rcfg.dtype!r}: the "
                         f"reference computes in {sorted(DTYPES)}")


def check_model(model: torch.nn.Module, cfg: ArchConfig,
                rcfg: RunConfig) -> None:
    """`model` must have been built with `rcfg`'s numerics (a model reads
    its compute dtype and SSD knobs when it is built): else ValueError."""
    want = (DTYPES[rcfg.dtype], rcfg.ssd_chunk or
            (cfg.ssm.chunk if cfg.ssm else 0), DTYPES[rcfg.ssd_compute_dtype])
    for m in model.modules():
        if isinstance(m, SSM):
            got = (model.dtype, m.chunk, m.ssd_dtype)
            break
    else:
        got = (model.dtype,) + want[1:]
    if got != want:
        raise ValueError(f"the model computes with (dtype, ssd chunk, ssd "
                         f"dtype) {got}, the RunConfig says {want}: build "
                         f"it with this RunConfig")


def train_state(model: torch.nn.Module) -> TrainState:
    """A fresh state around `model`: zero moments, step 0."""
    return {"params": model,
            "opt": adamw_init(dict(model.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32)}


def init_train_state(seed: int, cfg: ArchConfig, rcfg: RunConfig,
                     device: Union[str, torch.device, None] = None,
                     init: bool = True) -> TrainState:
    """The model's weights drawn from `seed` on `device` (the card unless
    it says otherwise), stored in fp32 and computed in `rcfg.dtype`, and
    a fresh optimizer state; `init=False` leaves the weights unset, for a
    restore to fill."""
    check_train_dtype(rcfg)
    model = init_fn_for(cfg)(cfg, rcfg, seed=seed, device=device, init=init,
                             param_dtype=torch.float32)
    return train_state(model)


def distribute_train_state(state: TrainState, mesh) -> TrainState:
    """Put `state` onto `mesh`, in place: the parameters by
    `param_specs`, the moments by `moment_specs`, as DTensors; `count`
    and `step` stay 0-d tensors on the CPU, the same on every rank."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding

    sharding.distribute_params(state["params"], mesh)
    opt = state["opt"]
    for key in ("mu", "nu"):
        specs = sharding.moment_specs(opt[key], mesh)
        opt[key] = {name: distribute_tensor(
            t, mesh, sharding.placements(mesh, specs[name]))
            for name, t in opt[key].items()}
    return state


def _on_mesh(model: torch.nn.Module):
    """A context under which a forward mixes plain tensors with DTensor
    parameters, the plain ones taken as replicated; a null context for
    a model on one device."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if any(isinstance(p, DTensor) for p in model.parameters()):
        return implicit_replication()
    return contextlib.nullcontext()


def make_train_step(cfg: ArchConfig, rcfg: RunConfig,
                    constrain: Optional[Callable] = None,
                    total_steps: int = 10_000) -> Callable:
    """Returns step(state, batch) → (state, metrics); `batch` is a dict
    of tensors on the model's device, `state["params"]` a model built
    with `rcfg` (`check_model`).  `constrain` goes to the loss, as in the
    reference (`lm_loss` applies it between layers)."""
    check_train_dtype(rcfg)
    loss_fn = loss_fn_for(cfg)
    warmup = min(100, max(1, total_steps // 10))

    def compute_grads(model: torch.nn.Module, batch: Dict[str, Any]):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        M = rcfg.microbatch
        if M and M > 1:
            loss_sum = torch.zeros(())
            for i in range(M):
                mb = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, metrics = loss_fn(model, mb, rcfg, constrain)
                loss.backward()
                loss_sum = loss_sum + loss.detach().cpu()
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(M)
            metrics = dict(metrics, loss=loss_sum / M)
        else:
            loss, metrics = loss_fn(model, batch, rcfg, constrain)
            loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        return params, grads, {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_model(state["params"], cfg, rcfg)
        with _on_mesh(state["params"]):
            params, grads, metrics = compute_grads(state["params"], batch)
        lr = cosine_schedule(state["step"], peak_lr=rcfg.learning_rate,
                             warmup_steps=warmup, total_steps=total_steps)
        _, _, opt_metrics = adamw_update(
            grads, state["opt"], params, lr,
            weight_decay=rcfg.weight_decay, grad_clip=rcfg.grad_clip)
        del grads
        for p in params.values():
            p.grad = None
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        state["step"] = state["step"] + 1
        return state, metrics

    return step
