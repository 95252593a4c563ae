"""Mean ms a step between one step's ``on_batch_end`` and the next step's
``on_batch_start`` in the window of the traced run: the trainer waiting
for its loader (``training/model_trainer.py`` ``train_loader``, a host
thread) and running its callbacks."""


def read(out, ctx):
    waits = out.record.get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
