"""K1's forward in the evaluation forward: % of its roofline (operations at
the bf16 peak)."""

from portbench.readers import k1


def read(ctx):
    return k1(ctx, "generate")
