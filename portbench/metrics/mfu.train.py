"""The whole GAN step's share of the card's dense bf16 peak: the model's
operations in the measured window (`work.train_step_flops` a step) over the
window's seconds x 989 TFLOP/s."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "train_gan")
