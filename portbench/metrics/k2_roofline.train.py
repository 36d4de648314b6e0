"""K2 (the fused GRU layer, forward and backward; the head's and the
discriminator's) in the GAN step: % of its roofline, its f32 products at
the 3xTF32 tensor-core rate (495 / 3 TFLOP/s), bytes at HBM bandwidth."""

from portbench.readers import k2


def read(ctx):
    return k2(ctx, "train_gan")
