"""ms of host time from the forward's call to its return (`infer.make_forward`
over `models.hop`): the enqueue of one batch; the mean of the window's
spans."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "forward") if ctx.kind == "generate" else None
