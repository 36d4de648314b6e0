"""Device ms a step of the operations enqueued inside torch's own
`Optimizer.step#Adam.step` ranges (`train.state`'s Adam on the generator and
the discriminator), in the stretch traced on host and device."""


def read(ctx):
    if ctx.kind != "train_gan" or ctx.host_trace is None or not ctx.host_traced_units:
        return None
    seconds = ctx.host_trace.seconds_under("Optimizer.step#Adam.step")
    return 1e3 * seconds / ctx.host_traced_units if seconds > 0.0 else None
