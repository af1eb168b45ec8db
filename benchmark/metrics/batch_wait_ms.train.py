"""Host time the train loop waited in ``DeviceBatches.take`` for its next
batch (the Feeder, its prefetch thread and the side-stream copy), mean per
step of the window, in ms."""


def read(ctx):
    w = ctx["window"]
    return w["batch_wait_ms"] if w.get("steps") else None
