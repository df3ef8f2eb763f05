"""Scoring schemes and their normalization (the port's own copy of
``bgsa_tpu.schemes``, same behaviour).

The reference derives, at code-generation time, a "factor" that relates the
kernel's internal integer DP to the user-requested scores
(``generator/source/.../main/Main.java:213-272`` in the reference):

* Myers / banded Myers only handle unit weights ``(0, c, c)``; the kernel
  computes plain edit distance and multiplies by ``factor = c`` (e.g. the
  committed unit-cost kernels use ``factor = -1``).
* BitPAl handles general ``(M, I, G)`` with ``M >= 0 > I, G``; scores are
  divided by ``gcd(|M|, |I|, |G|)`` before generation and the kernel epilogue
  multiplies the result back.

The port compares modes and algorithms by identity (``mode is
Mode.GLOBAL``), so an enum or dataclass of another package (``bgsa_tpu``'s
look-alikes included) would silently take the wrong branch. ``normalize``
and ``check_type`` refuse them with a ``TypeError`` instead.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Algorithm(enum.Enum):
    MYERS = "myers"
    BITPAL = "bitpal"
    BANDED = "banded"


class Mode(enum.Enum):
    GLOBAL = "global"
    SEMI_GLOBAL = "semi-global"


@dataclasses.dataclass(frozen=True)
class Scoring:
    """User-facing alignment weights (match >= 0, mismatch/gap <= 0 typically)."""

    match: int = 0
    mismatch: int = -1
    gap: int = -1

    @property
    def is_unit(self) -> bool:
        """True when representable by Myers' unit-cost edit distance."""
        return self.match == 0 and self.mismatch == self.gap and self.mismatch != 0


@dataclasses.dataclass(frozen=True)
class NormalizedScheme:
    """Scheme after factor extraction, ready for a kernel."""

    algorithm: Algorithm
    mode: Mode
    # Reduced scores actually run inside the kernel.
    match: int
    mismatch: int
    gap: int
    # Final score = kernel_result * factor.
    factor: int


def check_type(value, cls, name: str) -> None:
    """Raise TypeError unless ``value`` is an instance of the port's ``cls``."""
    if not isinstance(value, cls):
        raise TypeError(
            f"{name} must be bgsa_tpu_torch's {cls.__name__}, got "
            f"{type(value).__module__}.{type(value).__qualname__}"
        )


def normalize(
    scoring: Scoring,
    mode: Mode = Mode.GLOBAL,
    algorithm: Algorithm | None = None,
) -> NormalizedScheme:
    """Pick the kernel family and reduced integer weights for ``scoring``.

    Mirrors the reference generator's normalization: unit schemes go to Myers
    with ``factor = mismatch``; everything else goes to BitPAl with the GCD
    divided out. Raises TypeError on a ``Scoring``, ``Mode`` or
    ``Algorithm`` that is not this module's.
    """
    check_type(scoring, Scoring, "scoring")
    check_type(mode, Mode, "mode")
    if algorithm is not None:
        check_type(algorithm, Algorithm, "algorithm")
    if algorithm is Algorithm.BANDED:
        if not scoring.is_unit or abs(scoring.mismatch) != 1:
            raise ValueError("banded Myers requires unit weights (0, ±1, ±1)")
        return NormalizedScheme(Algorithm.BANDED, mode, 0, -1, -1, scoring.mismatch)

    if algorithm is Algorithm.MYERS or (algorithm is None and scoring.is_unit):
        if not scoring.is_unit:
            raise ValueError(f"Myers requires unit weights (0, c, c), got {scoring}")
        return NormalizedScheme(Algorithm.MYERS, mode, 0, -1, -1, scoring.mismatch)

    # BitPAl general integer scoring.
    if scoring.match < 0:
        raise ValueError("BitPAl requires match >= 0")
    if scoring.gap >= 0 or scoring.mismatch >= scoring.match:
        raise ValueError(f"BitPAl requires gap < 0 and mismatch < match, got {scoring}")
    factor = math.gcd(abs(scoring.match), math.gcd(abs(scoring.mismatch), abs(scoring.gap)))
    factor = max(factor, 1)
    return NormalizedScheme(
        Algorithm.BITPAL,
        mode,
        scoring.match // factor,
        scoring.mismatch // factor,
        scoring.gap // factor,
        factor,
    )
