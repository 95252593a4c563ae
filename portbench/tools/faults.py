"""Faults planted under the timed path, for the fault tests and for
readings of a fault on the card (``tools/readings.py``): a predict
layer's answer altered where it is produced; a training step that
returns its state unchanged; a training step that leaves out half of
each batch, the mean taken over the rest."""

from __future__ import annotations

from portbench.entries import predict, train


def altered_answers(ctx):
    """The program's layer whose host step moves every keypoint of each
    frame's first instance by three pixels."""
    layer, states = predict.program_layer(ctx)
    post = layer.postprocess_host

    def postprocess_host(host):
        out = post(host)
        out["pred_keypoints"][:, 0] += 3.0
        return out

    layer.postprocess_host = postprocess_host
    return layer, states


def unchanged_state(ctx, train_labels, val_labels):
    """A trainer whose optimizer step leaves the weights as they were."""
    trainer = train.program_trainer(ctx, train_labels, val_labels)
    trainer.optimizer.step = lambda closure=None: None
    return trainer


def half_batch(ctx, train_labels, val_labels):
    """A trainer whose loss leaves out half of each batch, the mean taken
    over the rest."""
    trainer = train.program_trainer(ctx, train_labels, val_labels)
    loss_of = trainer.compute_loss

    def compute_loss(processed, train):
        n = processed["image"].shape[0]
        half = {k: v[: n // 2] if hasattr(v, "shape") and v.ndim and v.shape[0] == n else v
                for k, v in processed.items()}
        return loss_of(half, train)

    trainer.compute_loss = compute_loss
    return trainer


FAULTS = {"altered_answers": altered_answers, "unchanged_state": unchanged_state,
          "half_batch": half_batch}
