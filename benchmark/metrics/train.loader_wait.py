"""Share of the window's epochs that the training loop spent waiting on
its loader (``Trainer.epoch_stats``: ``data_secs`` over ``secs``)."""


def read(window):
    epochs = window.record.get("epochs")
    if not epochs:
        return None
    return 100.0 * sum(e["data_secs"] for e in epochs) / sum(
        e["secs"] for e in epochs)
