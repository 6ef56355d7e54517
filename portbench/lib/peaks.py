"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full power limit of 700 W), against which a least time is
counted. TF32 on the tensor cores is the fastest rate at which any
product accurate to float32 could run, so a kernel that computes its
product another way cannot read above 100 % of a bound taken from it."""

#: HBM3 bandwidth, bytes a second.
HBM_BYTES_S = 3.35e12
#: TF32 dense matrix products on the tensor cores, flop a second.
TF32_FLOP_S = 495e12
#: float32 outside the tensor cores, flop a second.
F32_FLOP_S = 67e12


def least_s(bytes_: float = 0.0, product_flop: float = 0.0,
            other_flop: float = 0.0) -> float:
    """The least time of some work: the largest of its bytes at the
    memory's rate, its matrix-product flop at TF32's and its other float32
    flop at float32's."""
    return max(bytes_ / HBM_BYTES_S, product_flop / TF32_FLOP_S,
               other_flop / F32_FLOP_S)
