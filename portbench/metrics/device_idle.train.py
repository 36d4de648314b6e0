"""% of the GAN cells' stretch traced on the device alone (whose cost to the
host is small) in which no operation ran on the card, from the profiler's
timeline; the stretch's length from a pair of events."""

from portbench.readers import idle


def read(ctx):
    return idle(ctx, "train_gan")
