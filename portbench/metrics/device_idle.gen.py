"""% of the generation cell's stretch traced on the device alone in which no
operation ran on the card; the stretch's length from a pair of events."""

from portbench.readers import idle


def read(ctx):
    return idle(ctx, "generate")
