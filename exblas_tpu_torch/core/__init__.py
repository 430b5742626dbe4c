from .types import (
    AccFormat,
    DOT_FORMAT,
    LIMB_BASE,
    LIMB_BITS,
    LIMB_MASK,
    L_DOT,
    L_SUM,
    SUM_FORMAT,
    Superacc,
)
from .ieee import decode_fields, f64_bits
from .rounding import (
    bits_to_float,
    canonicalize_digits,
    ieee_encode_round,
    round_superacc_to_f64_bits,
)

__all__ = [
    "AccFormat",
    "DOT_FORMAT",
    "LIMB_BASE",
    "LIMB_BITS",
    "LIMB_MASK",
    "L_DOT",
    "L_SUM",
    "SUM_FORMAT",
    "Superacc",
    "bits_to_float",
    "canonicalize_digits",
    "decode_fields",
    "f64_bits",
    "ieee_encode_round",
    "round_superacc_to_f64_bits",
]
