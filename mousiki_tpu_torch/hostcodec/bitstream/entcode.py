"""Range (arithmetic) coder — the normative Opus entropy layer (RFC 6716 §4.1).

This is the inherently-serial, byte-granular stage of the pipeline: it runs
on the host and feeds symbol/coefficient tensors to the batched TPU stages.
Behavioral parity target: reference `src/celt/entcode.rs`, `entdec.rs`,
`entenc.rs` (mousiki); both are implementations of the same normative
algorithm.

The coder processes the buffer from both ends: range-coded symbols from the
front, raw bits ("extra bits") from the back, so the two can share one
buffer without knowing its final split point.
"""

from __future__ import annotations

EC_SYM_BITS = 8
EC_CODE_BITS = 32
EC_SYM_MAX = (1 << EC_SYM_BITS) - 1
EC_CODE_TOP = 1 << (EC_CODE_BITS - 1)
EC_CODE_BOT = EC_CODE_TOP >> EC_SYM_BITS
EC_CODE_EXTRA = (EC_CODE_BITS - 2) % EC_SYM_BITS + 1
EC_CODE_SHIFT = EC_CODE_BITS - EC_SYM_BITS - 1
EC_WINDOW_SIZE = 32
EC_UINT_BITS = 8
BITRES = 3

_MASK32 = 0xFFFFFFFF


def ec_ilog(v: int) -> int:
    """Number of bits needed to represent v (position of highest set bit + 1)."""
    return v.bit_length()


def celt_udiv(n: int, d: int) -> int:
    return n // d


class RangeCoderBase:
    """State shared by encoder and decoder: buffer + bit accounting."""

    __slots__ = (
        "buf", "storage", "end_offs", "end_window", "nend_bits",
        "nbits_total", "offs", "rng", "val", "ext", "rem", "error",
    )

    def tell(self) -> int:
        """Total number of whole bits read/written so far (conservative)."""
        return self.nbits_total - ec_ilog(self.rng)

    def tell_frac(self) -> int:
        """Bits read/written in 1/8th-bit (BITRES) resolution."""
        nbits = self.nbits_total << BITRES
        l = ec_ilog(self.rng)
        r = self.rng >> (l - 16)
        for _ in range(BITRES):
            r = (r * r) >> 15
            b = r >> 16
            l = (l << 1) | b
            r >>= b
        return nbits - l

    def range_bytes(self) -> int:
        return self.offs

    def get_error(self) -> int:
        return self.error


class RangeDecoder(RangeCoderBase):
    """Range decoder over an immutable byte buffer.

    One instance is the single source of truth for a packet's symbol stream;
    the CELT/SILK host parsers pull typed symbols out of it and pack them
    into dense per-frame descriptor arrays for the device stages.
    """

    def __init__(self, buf: bytes | bytearray | memoryview):
        self.buf = bytes(buf)
        self.storage = len(self.buf)
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = (
            EC_CODE_BITS + 1
            - ((EC_CODE_BITS - EC_CODE_EXTRA) // EC_SYM_BITS) * EC_SYM_BITS
        )
        self.offs = 0
        self.rng = 1 << EC_CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (EC_SYM_BITS - EC_CODE_EXTRA))
        self.ext = 0
        self.error = 0
        self._normalize()

    # -- byte IO ----------------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    # -- renormalisation --------------------------------------------------
    def _normalize(self) -> None:
        while self.rng <= EC_CODE_BOT:
            self.nbits_total += EC_SYM_BITS
            self.rng = (self.rng << EC_SYM_BITS) & _MASK32
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << EC_SYM_BITS) | self.rem) >> (EC_SYM_BITS - EC_CODE_EXTRA)
            self.val = (
                ((self.val << EC_SYM_BITS) + (EC_SYM_MAX & ~sym)) & (EC_CODE_TOP - 1)
            )

    # -- core symbol decode ----------------------------------------------
    def decode(self, ft: int) -> int:
        """Return a frequency in [0, ft) identifying the next symbol's bucket."""
        self.ext = celt_udiv(self.rng, ft)
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    # -- convenience decoders --------------------------------------------
    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = 1 if d < s else 0
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        """Decode a symbol with an 8-bit 'inverse CDF' table (icdf[k] = ft - cdf[k+1])."""
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            t = s
            ret += 1
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_icdf16(self, icdf, ftb: int) -> int:
        """Same as dec_icdf but with 16-bit table entries (used by DRED)."""
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            t = s
            ret += 1
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        """Decode a uniformly distributed integer in [0, ft)."""
        assert ft > 1
        ft -= 1
        ftb = ec_ilog(ft)
        if ftb > EC_UINT_BITS:
            ftb -= EC_UINT_BITS
            ft_hi = (ft >> ftb) + 1
            s = self.decode(ft_hi)
            self.update(s, s + 1, ft_hi)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        else:
            ft += 1
            s = self.decode(ft)
            self.update(s, s + 1, ft)
            return s

    def dec_bits(self, bits: int) -> int:
        """Decode raw bits from the back of the buffer."""
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while available <= EC_WINDOW_SIZE - EC_SYM_BITS:
                window |= self._read_byte_from_end() << available
                available += EC_SYM_BITS
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret


class RangeEncoder(RangeCoderBase):
    """Range encoder writing into a fixed-capacity bytearray."""

    def __init__(self, size: int):
        self.buf = bytearray(size)
        self.storage = size
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = EC_CODE_BITS + 1
        self.offs = 0
        self.rng = EC_CODE_TOP
        self.rem = -1
        self.val = 0
        self.ext = 0
        self.error = 0

    # -- byte IO ----------------------------------------------------------
    def _write_byte(self, value: int) -> int:
        if self.offs + self.end_offs >= self.storage:
            return -1
        self.buf[self.offs] = value
        self.offs += 1
        return 0

    def _write_byte_at_end(self, value: int) -> int:
        if self.offs + self.end_offs >= self.storage:
            return -1
        self.end_offs += 1
        self.buf[self.storage - self.end_offs] = value
        return 0

    # -- carry / renormalisation -----------------------------------------
    def _carry_out(self, c: int) -> None:
        if c != EC_SYM_MAX:
            carry = c >> EC_SYM_BITS
            if self.rem >= 0:
                self.error |= self._write_byte((self.rem + carry) & 0xFF)
            if self.ext > 0:
                sym = (EC_SYM_MAX + carry) & EC_SYM_MAX
                while self.ext > 0:
                    self.error |= self._write_byte(sym)
                    self.ext -= 1
            self.rem = c & EC_SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= EC_CODE_BOT:
            self._carry_out(self.val >> EC_CODE_SHIFT)
            self.val = (self.val << EC_SYM_BITS) & (EC_CODE_TOP - 1)
            self.rng = (self.rng << EC_SYM_BITS) & _MASK32
            self.nbits_total += EC_SYM_BITS

    # -- core symbol encode ----------------------------------------------
    def encode(self, fl: int, fh: int, ft: int) -> None:
        r = celt_udiv(self.rng, ft)
        if fl > 0:
            self.val = (self.val + self.rng - r * (ft - fl)) & _MASK32
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, bits: int) -> None:
        r = self.rng >> bits
        if fl > 0:
            self.val = (self.val + self.rng - r * ((1 << bits) - fl)) & _MASK32
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * ((1 << bits) - fh)
        self._normalize()

    # -- convenience encoders --------------------------------------------
    def enc_bit_logp(self, val: int, logp: int) -> None:
        r = self.rng
        l = self.val
        s = r >> logp
        r -= s
        if val:
            self.val = (l + r) & _MASK32
        self.rng = s if val else r
        self._normalize()

    def enc_icdf(self, s: int, icdf, ftb: int) -> None:
        r = self.rng >> ftb
        if s > 0:
            self.val = (self.val + self.rng - r * icdf[s - 1]) & _MASK32
            self.rng = r * (icdf[s - 1] - icdf[s])
        else:
            self.rng -= r * icdf[s]
        self._normalize()

    def enc_icdf16(self, s: int, icdf, ftb: int) -> None:
        r = self.rng >> ftb
        if s > 0:
            self.val = (self.val + self.rng - r * icdf[s - 1]) & _MASK32
            self.rng = r * (icdf[s - 1] - icdf[s])
        else:
            self.rng -= r * icdf[s]
        self._normalize()

    def enc_uint(self, fl: int, ft: int) -> None:
        """Encode fl, uniformly distributed in [0, ft)."""
        assert ft > 1
        ft -= 1
        ftb = ec_ilog(ft)
        if ftb > EC_UINT_BITS:
            ftb -= EC_UINT_BITS
            ft_hi = (ft >> ftb) + 1
            fl_hi = fl >> ftb
            self.encode(fl_hi, fl_hi + 1, ft_hi)
            self.enc_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode(fl, fl + 1, ft + 1)

    def enc_bits(self, fl: int, bits: int) -> None:
        """Append raw bits at the back of the buffer."""
        window = self.end_window
        used = self.nend_bits
        assert bits > 0
        if used + bits > EC_WINDOW_SIZE:
            while used >= EC_SYM_BITS:
                self.error |= self._write_byte_at_end(window & EC_SYM_MAX)
                window >>= EC_SYM_BITS
                used -= EC_SYM_BITS
        window |= fl << used
        used += bits
        self.end_window = window
        self.nend_bits = used
        self.nbits_total += bits

    # -- finalisation -----------------------------------------------------
    def patch_initial_bits(self, val: int, nbits: int) -> None:
        """Rewrite the first nbits of the stream (used for TOC-adjacent flags)."""
        shift = EC_SYM_BITS - nbits
        mask = ((1 << nbits) - 1) << shift
        if self.offs > 0:
            self.buf[0] = (self.buf[0] & ~mask) | (val << shift)
        elif self.rem >= 0:
            self.rem = (self.rem & ~mask) | (val << shift)
        elif self.rng <= (EC_CODE_TOP >> nbits):
            self.val = (
                (self.val & ~(mask << EC_CODE_SHIFT))
                | (val << (EC_CODE_SHIFT + shift))
            ) & _MASK32
        else:
            self.error = -1

    def shrink(self, size: int) -> None:
        """Reduce buffer capacity to `size`, relocating the raw-bit tail."""
        assert self.offs + self.end_offs <= size
        tail = self.buf[self.storage - self.end_offs: self.storage]
        self.buf[size - self.end_offs: size] = tail
        self.storage = size
        del self.buf[size:]

    def save(self) -> tuple:
        """Snapshot for encoder retry loops (VBR rate search)."""
        return (
            bytes(self.buf), self.storage, self.end_offs, self.end_window,
            self.nend_bits, self.nbits_total, self.offs, self.rng, self.val,
            self.ext, self.rem, self.error,
        )

    def restore(self, snap: tuple) -> None:
        (buf, self.storage, self.end_offs, self.end_window, self.nend_bits,
         self.nbits_total, self.offs, self.rng, self.val, self.ext, self.rem,
         self.error) = snap
        self.buf = bytearray(buf)

    def done(self) -> None:
        """Flush: output the minimum bits that uniquely identify the interval."""
        l = EC_CODE_BITS - ec_ilog(self.rng)
        msk = (EC_CODE_TOP - 1) >> l
        end = (self.val + msk) & ~msk & _MASK32
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk & _MASK32
        while l > 0:
            self._carry_out(end >> EC_CODE_SHIFT)
            end = (end << EC_SYM_BITS) & (EC_CODE_TOP - 1)
            l -= EC_SYM_BITS
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        window = self.end_window
        used = self.nend_bits
        while used >= EC_SYM_BITS:
            self.error |= self._write_byte_at_end(window & EC_SYM_MAX)
            window >>= EC_SYM_BITS
            used -= EC_SYM_BITS
        if not self.error:
            for i in range(self.offs, self.storage - self.end_offs):
                self.buf[i] = 0
            if used > 0:
                if self.end_offs >= self.storage:
                    self.error = -1
                else:
                    l = -l
                    if self.offs + self.end_offs >= self.storage and l < used:
                        window &= (1 << l) - 1
                        self.error = -1
                    self.buf[self.storage - self.end_offs - 1] |= window & 0xFF

    def data(self) -> bytes:
        return bytes(self.buf[: self.storage])
