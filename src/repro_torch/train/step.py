"""The training step (``repro.train.step``): loss -> gradients -> optional
int8 error-feedback compression -> AdamW update.

``make_train_step`` returns ``train_step(state, batch) -> (state, metrics)``
over a state of plain trees: ``{"params", "opt", "step", "err"}``, the
parameters f32 master copies (the model casts them to its compute type
inside each block, as the reference does). Each step takes a gradient of
every parameter leaf with ``torch.autograd.grad``; on the card the norms,
the gated FFN's product and prefill attention run through the kernels and
their backward kernels. Microbatches sum their gradients in f32 and divide
by their count; the loss is their mean and the other metrics the last
microbatch's (the reference's scan). The optimizer's update is functional:
a new state is returned and the old one may be dropped.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.collectives import (
    DEFAULT_BUCKET_BYTES,
    ef_compress_grads,
    ef_compress_grads_bucketed,
)
from repro_torch.models import transformer as T
from repro_torch.models.registry import ModelApi
from repro_torch.optim.adamw import (
    AdamW,
    AdamWState,
    tree_leaves,
    tree_map,
    tree_unflatten,
    warmup_cosine,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1  # gradient accumulation
    compress_grads: bool = False  # int8 error-feedback compression
    # overlapped transport: bucket the EF all-reduces in reverse leaf order
    # (backward availability); numerically bit-identical to the synchronous
    # path, only the launch schedule changes
    overlap_grads: bool = False
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(
        lr=warmup_cosine(tc.lr, tc.warmup, tc.total_steps),
        weight_decay=tc.weight_decay,
        clip_norm=tc.clip_norm,
    )


def init_train_state(api: ModelApi, optimizer: AdamW, seed: int = 0,
                     compress_grads: bool = False) -> dict:
    """Parameters from ``api.init(seed)`` as a plain tree, the optimizer's
    moments, the step, and the error-feedback buffer, allocated now when
    compressing so that the state's structure is the same every step."""
    params = T.tree_map(lambda t: t.detach(), api.init(seed))
    err = (
        tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        if compress_grads
        else None
    )
    return {"params": params, "opt": optimizer.init(params), "step": 0, "err": err}


def train_state_pspecs(state_shapes: dict, mesh) -> dict:
    """PartitionSpecs for a full train-state tree (params, optimizer moments,
    error-feedback buffer): the single source of truth for launchers. The
    err subtree mirrors the params whenever it exists. Leaves may be
    tensors, meta tensors or ``dist.sharding.LeafShape``s; per-layer lists
    get per-layer specs (``dist.sharding.param_pspecs``)."""
    from repro_torch.dist.sharding import PartitionSpec as P
    from repro_torch.dist.sharding import param_pspecs

    return {
        "params": param_pspecs(state_shapes["params"], mesh),
        "opt": AdamWState(
            step=P(),
            mu=param_pspecs(state_shapes["opt"].mu, mesh),
            nu=param_pspecs(state_shapes["opt"].nu, mesh),
        ),
        "step": P(),
        "err": (
            param_pspecs(state_shapes["err"], mesh)
            if state_shapes["err"] is not None
            else None
        ),
    }


def make_train_step(api: ModelApi, optimizer: AdamW, tc: TrainConfig):
    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = api.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            loss, metrics, grads = grads_of(params, batch)
            return loss, metrics, tree_unflatten(params, grads)
        m = tc.microbatches

        def split(x):
            if x.shape[0] % m:
                raise ValueError(f"batch of {x.shape[0]} does not split into {m} microbatches")
            return x.reshape(m, x.shape[0] // m, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
        loss_sum = 0.0
        for i in range(m):
            loss, metrics, grads = grads_of(params, {k: v[i] for k, v in micro.items()})
            acc = [a + g for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss
        return loss_sum / m, metrics, tree_unflatten(params, [a / m for a in acc])

    def train_step(state, batch):
        loss, metrics, grads = compute_grads(state["params"], batch)
        err = state.get("err")
        with torch.no_grad():
            if tc.compress_grads:
                if tc.overlap_grads:
                    grads, err, _ = ef_compress_grads_bucketed(
                        grads, err, bucket_bytes=tc.bucket_bytes
                    )
                else:
                    grads, err = ef_compress_grads(grads, err)
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state["opt"], state["params"]
            )
        new_state = {
            "params": new_params,
            "opt": new_opt,
            "step": state["step"] + 1,
            "err": err,
        }
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
