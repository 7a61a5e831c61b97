"""Operations and bytes of the model's products, and the card's peaks (the
benchmark's frozen copy of `chip_smoke.py::work`'s arithmetic).

A record (from `reference.models`) describes one product: its role, the
batch b, rows c_in / c_out, widths f_in / f_out, kernel volume k and the
valid map entries nnz (for dense layers the valid rows).  Operations are
2 * nnz * f_in * f_out.  Bytes count each input read once and each output
written once, 4 bytes a float and an index, whatever the kernel reads again.

Which of the program's kernels computes a product (`KERNEL_OF`) is the
program's dispatch as the yardstick assumes it: the eval forward runs the
self convs on gather_conv (BatchNorm fused into the store) and the down
convs on tdown; training runs the self and down convs, the self convs' dX
and the transposed convs' dX on gather_conv and the self and down convs' dW
on gather_dw.  The roofline readers time the kernels named `egonn::gather_mm*`
(gather_conv, every body and its sum pass) and `egonn::gather_dw*`.
"""
from __future__ import annotations

from typing import Iterable, Optional

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# The dense TF32 tensor-core rate: the highest rate at which the card
# multiplies f32 operands at all (the split-TF32 kernels run on the tensor
# cores, so a share of the 67 TFLOP/s f32 FMA rate could pass 100%).
F32_OPERAND_OPS_PER_S = 495e12

KERNEL_OF = {
    ("self", False): "gather_conv",
    ("down", False): "tdown",
    ("self", True): "gather_conv",
    ("down", True): "gather_conv",
    ("self_dx", True): "gather_conv",
    ("tconv_dx", True): "gather_conv",
    ("self_dw", True): "gather_dw",
    ("down_dw", True): "gather_dw",
}
KERNEL_PREFIX = {"gather_conv": "egonn::gather_mm", "gather_dw": "egonn::gather_dw"}


def kernel_of(r: dict) -> Optional[str]:
    return KERNEL_OF.get((r["role"], r["train"]))


def ops(r: dict) -> float:
    return 2.0 * r["nnz"] * r["f_in"] * r["f_out"]


def nbytes(r: dict) -> float:
    """Bytes of the kernel that computes the record, as `kernel_of` names it."""
    b, k, ci, co, fi, fo = r["b"], r["k"], r["c_in"], r["c_out"], r["f_in"], r["f_out"]
    w = k * fi * fo
    role = r["role"]
    if role == "down" and not r["train"]:      # tdown: features, up map, W, out, epilogue
        return 4.0 * (b * ci * fi + 2 * b * ci + w + b * co * fo + 2 * fo) + b * co
    if role in ("self", "down"):                # gather_conv: features, map, W, out
        epi = 0 if r["train"] else 4.0 * 2 * fo + b * co
        return 4.0 * (b * ci * fi + b * k * co + w + b * co * fo) + epi
    if role == "self_dx":                       # g, the reversed map, W^T, dX
        return 4.0 * (b * co * fo + b * k * co + w + b * ci * fi)
    if role == "tconv_dx":                      # g (fine), the coarse kmap_down, W^T, dX (coarse)
        return 4.0 * (b * co * fo + b * 8 * ci + w + b * ci * fi)
    if role.endswith("_dw"):                    # features, map, g, dW
        return 4.0 * (b * ci * fi + b * k * co + b * co * fo + w)
    return 4.0 * (b * ci * fi + b * co * fo + w)


def least_seconds(records: Iterable[dict]) -> float:
    """Sum over the records of the larger of bytes / HBM rate and
    operations / the f32-operand peak."""
    return sum(max(nbytes(r) / HBM_BYTES_PER_S, ops(r) / F32_OPERAND_OPS_PER_S)
               for r in records)


def total_ops(records: Iterable[dict]) -> float:
    return sum(ops(r) for r in records)
