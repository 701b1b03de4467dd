"""Train and serve step factories (port of ``repro.train.train_loop``), for
one device and no mesh.

``make_train_step(model, opt_cfg, n_micro=1)`` gives ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: the mean loss over
``n_micro`` microbatches, its gradient, then AdamW; ``metrics`` holds
``loss``, ``grad_norm`` and ``lr`` (0-d tensors on the device). The
reference's shardings, activation constraints and mesh are left out: the
port trains on one device. The reference donates params and optimizer
state to its jitted step; here the update writes into them in place
(``optimizer.adamw_update``), so a caller that keeps the old values clones
them first.

``prefill_step(params, batch)`` is one full-sequence ``Model.forward`` and
the logits of the last position; ``decode_step`` is ``Model.decode_step``.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.train import optimizer as optlib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def loss_with_microbatch(model: Model, params, batch, n_micro: int):
    """Mean loss over ``n_micro`` microbatches (the batch's leading axis cut
    into equal parts), accumulated in float32 in the reference's order. The
    reference also checkpoints each microbatch's whole loss; here every
    layer and loss block is already recomputed in the backward
    (``cfg.remat``), which bounds the memory a microbatch holds to its layer
    inputs, so the microbatch is not recomputed a second time."""
    if n_micro <= 1:
        return model.loss(params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    parts = {k: x.chunk(n_micro) for k, x in batch.items()}
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(n_micro):
        total = total + model.loss(params, {k: v[i] for k, v in parts.items()})
    return total / n_micro


def value_and_grad(model: Model, params, batch, n_micro: int = 1):
    """(mean loss, gradient tree of ``params``'s structure): the
    reference's ``jax.value_and_grad`` of ``loss_with_microbatch``."""
    tracked = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss = loss_with_microbatch(model, tracked, batch, n_micro)
    grads = torch.autograd.grad(loss, tree_leaves(tracked))
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: optlib.OptConfig, *,
                    n_micro: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; params and state are updated in place."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch, n_micro)
        params, opt_state, metrics = optlib.adamw_update(
            opt_cfg, grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_serve_steps(model: Model):
    """Returns (prefill_step, decode_step)."""

    def prefill_step(params, batch):
        hidden, _ = model.forward(params, batch)
        return model.logits(params, hidden[:, -1:, :])[:, 0]

    return prefill_step, model.decode_step
