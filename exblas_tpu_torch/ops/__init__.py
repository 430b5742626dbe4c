from .exdot import exdot, exdot_acc, exdot_bits
from .exgemm import exgemm, exgemm_bits
from .exgemv import exgemv, exgemv_bits
from .extrsv import extrsv, extrsv_bits
from .exsum import (exsum, exsum_acc, exsum_bits, exsum_segmented,
                    exsum_segmented_bits)

__all__ = ["exsum", "exsum_acc", "exsum_bits", "exsum_segmented",
           "exsum_segmented_bits", "exdot", "exdot_acc",
           "exdot_bits", "exgemv", "exgemv_bits", "extrsv", "extrsv_bits",
           "exgemm", "exgemm_bits"]
