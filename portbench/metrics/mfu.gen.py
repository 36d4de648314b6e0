"""The whole evaluation forward's share of the card's dense bf16 peak: the
model's operations in the measured window (`work.generate_flops` a call)
over the window's seconds x 989 TFLOP/s."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "generate")
