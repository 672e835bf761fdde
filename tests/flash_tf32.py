"""Split TF32 (3xTF32) as the port's fp32 flash kernels form their products
on the tensor cores, emulated on the CPU for the tests of both directions
(`test_torch_port_flash.py`, `test_torch_port_flash_bwd.py`)."""

import torch


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest on the
    10 mantissa bits kept, ties away from zero, the low 13 bits 0; the
    kernels' `tf32_rna` (csrc/flash_common.cuh) is the same two integer
    operations on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_split(a, b, passes=3):
    """a @ b as the fp32 kernels form it on the tensor cores: a = hi + lo
    with hi = tf32(a) and lo = tf32(a - hi) (b alike), and a b = hi hi' +
    hi lo' + lo hi', each product exact in fp32 (11-bit significands) and
    summed in fp32; `passes=1` is one TF32 product, hi hi' alone."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return torch.matmul(ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.matmul(ah, bl) + torch.matmul(al, bh)
            + torch.matmul(ah, bh))
