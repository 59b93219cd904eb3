"""Shape bucketing for the serving paths.

:func:`next_pow2` is the canonical shape-bucketing function: every count-keyed
decode dimension (live decode rows, sampler rows) rounds the count up to a
power of two first, so the set of distinct shapes is log-sized instead of
linear in the count.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n``, with ``next_pow2(0) == 1``.

    Zero maps to 1 because every padded batch needs at least one row."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()
