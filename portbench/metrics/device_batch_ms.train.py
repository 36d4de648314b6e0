"""ms of host time to make one batch from the record store and move it to the
card (`SpeechMotionDataset.make_batch`, `cli.common.device_batch`): the
mean over the batches made while the window is open, timed where they are
made, on the feed's thread where it runs ahead."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "device_batch") if ctx.kind == "train_gan" else None
