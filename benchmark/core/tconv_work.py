"""Operations and bytes of the transposed k=2 s=2 conv (the program's
`tconv` kernel), and its share of its roofline.

A record of role `tconv` (`reference.models.tconv2x2`) describes one
transposed conv of a batch: b clouds, c_in coarse rows of f_in features,
c_out fine rows of f_out, nnz the fine rows with a parent.  Each such row
is its parent's features times its own slot's kernel: 2 * nnz * f_in *
f_out useful operations (not the 8 slots of the all-slot product).  Bytes
count each input read once and the output written once, 4 bytes a float
and an index: the coarse features, each fine row's parent and its place in
the slot order, the 8 kernels, every fine row of the output.
"""
from __future__ import annotations

from typing import Iterable, Optional

from benchmark.core import work

KERNEL_PREFIX = "egonn::tconv_kernel"


def records(rs: Iterable[dict]) -> list:
    return [r for r in rs if r["role"] == "tconv" and not r["train"]]


def ops(r: dict) -> float:
    return 2.0 * r["nnz"] * r["f_in"] * r["f_out"]


def nbytes(r: dict) -> float:
    b, ci, co, fi, fo = r["b"], r["c_in"], r["c_out"], r["f_in"], r["f_out"]
    return 4.0 * (b * ci * fi + 2 * b * co + 8 * fi * fo + b * co * fo)


def least_seconds(rs: Iterable[dict]) -> float:
    """Sum over the records of the larger of bytes / HBM rate and
    operations / the f32-operand peak."""
    return sum(max(nbytes(r) / work.HBM_BYTES_PER_S, ops(r) / work.F32_OPERAND_OPS_PER_S)
               for r in rs)


def roofline(ctx) -> Optional[float]:
    """Per cent: the least time of the traced calls' transposed convs over
    the device time of the kernels named `egonn::tconv_kernel*`; None where
    either is missing."""
    if ctx.trace is None or not ctx.trace.kernels or ctx.traced_calls <= 0:
        return None
    measured = ctx.trace.kernel_seconds(lambda n: n.startswith(KERNEL_PREFIX))
    rs = records(ctx.traced_records)
    if measured <= 0 or not rs:
        return None
    return 100.0 * least_seconds(rs) / measured
