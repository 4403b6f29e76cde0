"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense,
at the full 700 W power limit).

The port computes float32 as 3xTF32 on the tensor cores, so the compute
peak that bounds it is the TF32 rate; the plain float32 rate (67 TFLOP/s)
is not used."""

TF32_FLOPS = 494.7e12        # FLOP/s, TF32 tensor cores
HBM_BYTES = 3.35e12          # bytes/s
