"""Device ms a GAN step: the time in which an operation ran on the card over
the stretch traced on the device alone, a step. Beside `host_step_ms.train`
it says which side paces the loop: the card where its step is the longer."""


def read(ctx):
    if ctx.kind != "train_gan" or ctx.trace is None or not ctx.traced_units:
        return None
    busy = ctx.trace.busy_s
    return 1e3 * busy / ctx.traced_units if busy > 0.0 else None
