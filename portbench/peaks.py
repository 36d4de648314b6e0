"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).

`TF32X3_FLOPS` is the rate of an f32 product computed as three TF32
products on the tensor cores (hi * hi + hi * lo + lo * hi), as the port's
GRU kernels compute theirs: a third of the TF32 rate. A kernel on the
tensor cores can pass the 67 TFLOP/s of the f32 units, so that rate is no
bound for them.
"""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
