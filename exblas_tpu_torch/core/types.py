"""Superaccumulator formats and the ``Superacc`` container (PyTorch).

Counterpart of ``exblas_tpu/core/types.py``.  The formats are the same bit
for bit, so accumulators interchange with the JAX package:

* ``LIMB_BITS`` = 20 payload bits per limb (base ``2**20``);
* ``SUM_FORMAT``: 112 limbs, bit 0 at ``2**-1074`` -- every bit a finite
  double can populate plus >= 64 bits of carry headroom;
* ``DOT_FORMAT``: 216 limbs, bit 0 at ``2**-2148`` -- the full range of
  exact products of two doubles, underflowing ones included.

An accumulator with limbs ``v[0..L-1]`` represents the exact integer
``V = sum_j v[j] * 2**(LIMB_BITS*j)`` and the real value
``V * 2**-offset_bits``.  Limbs are redundant (any signed int32 values);
only the canonical digits (``core.rounding.canonicalize_digits``) are
unique.  NaN/Inf are counted in a separate side channel.
"""

from __future__ import annotations

import dataclasses

import torch

LIMB_BITS = 20
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1

# IEEE-754 binary64: value = mant53 * 2**E, E = max(expfield,1) - 1075.
F64_MANT_BITS = 52
F64_EXP_SPECIAL = 0x7FF

SUM_OFFSET_BITS = 1074
L_SUM = 112  # 112*20 = 2240 bits >= 1074 + 1024 + 64

DOT_OFFSET_BITS = 2148
L_DOT = 216  # 216*20 = 4320 bits >= 2148 + 2048 + 64

# Indices in the "special" counter vector.
SPECIAL_NAN = 0
SPECIAL_POS_INF = 1
SPECIAL_NEG_INF = 2
N_SPECIAL = 3


@dataclasses.dataclass(frozen=True)
class AccFormat:
    """Static description of a superaccumulator layout."""

    n_limbs: int
    offset_bits: int  # bit 0 of the accumulator == 2**-offset_bits


SUM_FORMAT = AccFormat(n_limbs=L_SUM, offset_bits=SUM_OFFSET_BITS)
DOT_FORMAT = AccFormat(n_limbs=L_DOT, offset_bits=DOT_OFFSET_BITS)


@dataclasses.dataclass
class Superacc:
    """A (batch of) exact Kulisch superaccumulator(s).

    ``limbs``   : int32 tensor [..., n_limbs] -- base-2^20 signed limbs,
                  little-endian (the JAX package's canonical frame).
    ``special`` : int32 tensor [..., 3]       -- counts of (NaN, +Inf, -Inf).
    ``fmt``     : AccFormat.

    Merging two Superaccs is element-wise integer addition, which is
    associative and commutative: that is what makes every reduction
    bit-reproducible regardless of partitioning.
    """

    limbs: torch.Tensor
    special: torch.Tensor
    fmt: AccFormat

    @classmethod
    def zero(cls, fmt: AccFormat, batch_shape=(), device=None) -> "Superacc":
        return cls(
            limbs=torch.zeros(tuple(batch_shape) + (fmt.n_limbs,),
                              dtype=torch.int32, device=device),
            special=torch.zeros(tuple(batch_shape) + (N_SPECIAL,),
                                dtype=torch.int32, device=device),
            fmt=fmt,
        )

    def __add__(self, other: "Superacc") -> "Superacc":
        if self.fmt != other.fmt:
            raise ValueError(f"Superacc format mismatch: {self.fmt} vs "
                             f"{other.fmt}")
        return Superacc(
            limbs=self.limbs + other.limbs,
            special=self.special + other.special,
            fmt=self.fmt,
        )

    def dump(self) -> str:
        """Hex dump of the raw limb state, most significant limb first, with
        the special counters and the exact represented integer appended --
        the same text as the JAX package's ``Superacc.dump``."""
        limbs = self.limbs.detach().cpu().tolist()
        special = self.special.detach().cpu().tolist()
        if self.limbs.dim() > 1:
            return "\n".join(
                Superacc(limbs=self.limbs[i], special=self.special[i],
                         fmt=self.fmt).dump()
                for i in range(self.limbs.shape[0])
            )
        words = " ".join(format(int(v) & 0xFFFFFFFF, "08x")
                         for v in limbs[::-1])
        v = sum(int(x) << (LIMB_BITS * j) for j, x in enumerate(limbs))
        return (
            f"superacc[{self.fmt.n_limbs}x{LIMB_BITS}b "
            f"2^-{self.fmt.offset_bits}] {words} "
            f"| nan={int(special[0])} +inf={int(special[1])} "
            f"-inf={int(special[2])} | V={v}"
        )
