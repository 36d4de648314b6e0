"""K1 (the reprogramming attention, forward and backward) in the GAN step: %
of its roofline, the launches' least times (operations at the bf16 peak)
over their kernels' device time."""

from portbench.readers import k1


def read(ctx):
    return k1(ctx, "train_gan")
