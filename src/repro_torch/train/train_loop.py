"""Serve step factory (port of ``repro.train.train_loop.make_serve_steps``),
for one device and no mesh.

``prefill_step(params, batch)`` is one full-sequence ``Model.forward`` and
the logits of the last position; ``decode_step`` is ``Model.decode_step``.
``make_train_step`` waits for the loss and optimizer (ROADMAP Queue 1, LM
scaffold item 1).
"""

from __future__ import annotations

from repro_torch.models.model import Model


def make_serve_steps(model: Model):
    """Returns (prefill_step, decode_step)."""

    def prefill_step(params, batch):
        hidden, _ = model.forward(params, batch)
        return model.logits(params, hidden[:, -1:, :])[:, 0]

    return prefill_step, model.decode_step
