"""Bit-exact MT19937 (32-bit) matching the reference RNG stream.

The port's copy of the relation generator's random source (the JAX
package holds the same code in ``utils/mt19937.py``; the port imports
nothing of that package).  The reference KNL suite seeds one generator
per thread and draws all keys, repeat indices and shuffle positions from
it (npj.cpp:133-175).  Parity note: the reference's 32-bit *seeding*
recurrence omits the standard ``+ i`` term (``n[i+1] = 0x6c078965 *
(n[i] ^ (n[i] >> 30))``, npj.cpp:140-142), so standard MT19937 test
vectors do NOT apply.

Runs on the host (numpy): relation generation is a host-side, inherently
sequential contract (one RNG stream feeds rejection sampling and a
Fisher-Yates shuffle, write.cpp:1579-1585).
"""

from __future__ import annotations

import numpy as np

# All arithmetic here is modular by design, so overflow warnings are
# noise -- but suppression must stay LOCAL (np.errstate around the
# scalar seeding loop): a module-level np.seterr would silently disable
# overflow diagnostics for the whole embedding process.

_U32 = np.uint32

_N32 = 624
_M32 = 397
_UPPER32 = _U32(0x80000000)
_LOWER32 = _U32(0x7FFFFFFF)
_MATRIX32 = _U32(0x9908B0DF)


class MT19937:
    """32-bit Mersenne Twister with the reference's non-standard seeding."""

    def __init__(self, seed: int):
        n = np.empty(_N32, dtype=_U32)
        n[0] = _U32(seed & 0xFFFFFFFF)
        # npj.cpp:140-142 -- note: no "+ i" term.
        with np.errstate(over="ignore"):
            for i in range(_N32 - 1):
                n[i + 1] = _U32(0x6C078965) * (n[i] ^ (n[i] >> _U32(30)))
        self._state = n
        self._buf = np.empty(0, dtype=_U32)
        self._pos = 0

    def _twist(self) -> np.ndarray:
        n = self._state
        new = np.empty(_N32, dtype=_U32)

        def mag(y: np.ndarray) -> np.ndarray:
            return (y >> _U32(1)) ^ ((y & _U32(1)) * _MATRIX32)

        # chunk 1: i in [0, 227) reads old state only
        y = (n[0:227] & _UPPER32) + (n[1:228] & _LOWER32)
        new[0:227] = n[_M32 : _M32 + 227] ^ mag(y)
        # chunk 2: i in [227, 454) reads new[0:227]
        y = (n[227:454] & _UPPER32) + (n[228:455] & _LOWER32)
        new[227:454] = new[0:227] ^ mag(y)
        # chunk 3: i in [454, 623) reads new[227:396]
        y = (n[454:623] & _UPPER32) + (n[455:624] & _LOWER32)
        new[454:623] = new[227:396] ^ mag(y)
        # i = 623 wraps: n[624] = new n[0] (npj.cpp:152)
        y = (n[623] & _UPPER32) + (new[0] & _LOWER32)
        new[623] = new[396] ^ mag(y)

        self._state = new
        y = new.copy()
        y ^= y >> _U32(11)
        y ^= (y << _U32(7)) & _U32(0x9D2C5680)
        y ^= (y << _U32(15)) & _U32(0xEFC60000)
        y ^= y >> _U32(18)
        return y

    def next(self) -> int:
        return int(self.take(1)[0])

    def take(self, count: int) -> np.ndarray:
        """Next `count` tempered outputs as uint32."""
        out = np.empty(count, dtype=_U32)
        filled = 0
        while filled < count:
            if self._pos == len(self._buf):
                self._buf = self._twist()
                self._pos = 0
            m = min(count - filled, len(self._buf) - self._pos)
            out[filled : filled + m] = self._buf[self._pos : self._pos + m]
            self._pos += m
            filled += m
        return out
