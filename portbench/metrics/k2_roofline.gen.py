"""K2's lean forward in the evaluation forward (the head's four layers): % of
its roofline at the 3xTF32 rate."""

from portbench.readers import k2


def read(ctx):
    return k2(ctx, "generate")
