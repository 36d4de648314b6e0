"""ms of host time from the GAN step's call to its return (`train.llm` fused
step with its `StepNoise.draw`): the enqueue, with no wait for the card;
the mean of the window's spans."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "step") if ctx.kind == "train_gan" else None
