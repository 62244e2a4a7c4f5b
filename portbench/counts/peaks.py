"""The yardstick's peaks and rule, frozen.

One NVIDIA H100 SXM (data sheet, dense, no sparsity, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
The operations peak is the bf16 tensor-core rate, not the f32 one, so a
later kernel that moves the products onto the tensor cores still reads
at most 100 %.  A call's least time is the larger of its operations over
the operations peak and its bytes over the bytes peak; its bytes count
each input byte once and each output byte once, whatever the kernel
reads again.
"""
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
