"""Bit-level writer and reader with Exp-Golomb coding (host side).

Behavioral reference: `PCCBitstream`
(source/lib/PccLibBitstreamCommon/include/PCCBitstream.h:156-370):
u(n) fixed-width, ue(v)/se(v) Exp-Golomb, byte alignment.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def u(self, n: int, value: int) -> None:
        if n == 0:
            return
        value &= (1 << n) - 1
        self._acc = (self._acc << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def ue(self, value: int) -> None:
        assert value >= 0
        v = value + 1
        nbits = v.bit_length()
        self.u(nbits - 1, 0)
        self.u(nbits, v)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align(self, bit: int = 0) -> None:
        if self._nbits:
            self.u(8 - self._nbits, 0 if bit == 0 else (1 << (8 - self._nbits)) - 1)

    def bytes_(self, data: bytes) -> None:
        self.byte_align()
        self._buf.extend(data)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "call byte_align() before getvalue()"
        return bytes(self._buf)

    @property
    def size_bits(self) -> int:
        return len(self._buf) * 8 + self._nbits


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0   # byte position
        self._bit = 0   # bit position within byte (0 = MSB)

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos]
            v = (v << 1) | ((byte >> (7 - self._bit)) & 1)
            self._bit += 1
            if self._bit == 8:
                self._bit = 0
                self._pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 64:
                raise ValueError("malformed ue(v)")
        return ((1 << zeros) | self.u(zeros)) - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if (k & 1) else -(k // 2)

    def byte_align(self) -> None:
        if self._bit:
            self._bit = 0
            self._pos += 1

    def bytes_(self, n: int) -> bytes:
        self.byte_align()
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def more_data(self) -> bool:
        return self._pos < len(self._data)
