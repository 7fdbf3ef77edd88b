"""Zstandard frames in pure python (RFC 8878, without dictionaries).

The batch layer's blob envelope holds its payload as one zstd frame
(reference `types/batch/payload.py:33-45`, which calls the `zstandard`
package; the reference crates decode it in the guest with `vm-zstd`). This
module is the port's own codec, so that batch validation runs where no
`zstandard` package is installed.

`decompress(data, max_output_size)` follows
`zstandard.ZstdDecompressor().decompress(data, max_output_size=...)`
(python-zstandard 0.25.0):

- Only the first frame is decoded. Whatever follows it (another frame, a
  skippable frame, any bytes) is ignored.
- Input that starts with a skippable frame raises, unless that frame is
  empty: then, as for a frame that declares a content size of 0, the
  result is b"" and no block is read.
- A frame without a content size decodes up to `max_output_size` bytes,
  and raises if it would grow past it. Its window may be at most 2^27
  bytes (window log 27); with a declared content size, window logs up to
  31 decode.
- A frame that names a dictionary (an ID other than 0) raises, unless it
  declares a content size of 0.
- A frame whose checksum flag is set has its content checksum verified
  (the low 32 bits of XXH64, seed 0).

It differs from `zstandard` in two places. A frame that declares a
content size above `max_output_size` raises here before anything is
decoded, where `zstandard` trusts the declared size and decodes it:
output never grows past `max_output_size`. And a Huffman-coded literals
stream whose bits do not end exactly at its last symbol raises here,
where libzstd returns bytes that depend on how its decoder reads past the
end (so no rule reproduces them). Malformed input raises `ValueError`.

`compress(data)` writes one frame with the single-segment flag, the
content size, Raw blocks of at most 128 KiB and no checksum. It is NOT
`zstandard` level 3: it compresses nothing, so an envelope built with it
has other body bytes (and through the blob another versioned hash and
batch hash) than one built by the reference, while every payload decodes
to the same bytes.

`counts` tallies the block, literals and sequence-mode types decoded, and
the Huffman weight encodings, as the kernels' launch counters do.
"""

from __future__ import annotations

from collections import Counter

MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC_MASK = 0xFFFFFFF0
SKIPPABLE_MAGIC = 0x184D2A50
BLOCK_SIZE_MAX = 1 << 17
# the largest window the one-shot decoder accepts: libzstd's default limit
# for a frame without a content size, and its hard limit for one with a
# declared content size (which bounds the output on its own)
WINDOW_LOG_MAX = 27
WINDOW_LOG_MAX_SIZED = 31

# what the decoder has decoded since the last reset (keys below)
counts: Counter = Counter()
COUNT_KEYS = (
    "frame", "checksum",
    "block_raw", "block_rle", "block_compressed",
    "literals_raw", "literals_rle", "literals_huffman_1", "literals_huffman_4",
    "literals_treeless",
    "huffman_weights_fse", "huffman_weights_direct",
    "seq_predefined", "seq_rle", "seq_fse_compressed", "seq_repeat",
)


def reset_counts() -> None:
    counts.clear()
    for key in COUNT_KEYS:
        counts[key] = 0


reset_counts()


class _Corrupt(ValueError):
    pass


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise _Corrupt(f"zstd: {what}")


# ---------------------------------------------------------------------------
# XXH64 (the content checksum)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 with seed 0."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (_P1 + _P2) & _M64
        v2 = _P2
        v3 = 0
        v4 = -_P1 & _M64
        frm = int.from_bytes
        while i + 32 <= n:
            v1 = _round(v1, frm(data[i:i + 8], "little"))
            v2 = _round(v2, frm(data[i + 8:i + 16], "little"))
            v3 = _round(v3, frm(data[i + 16:i + 24], "little"))
            v4 = _round(v4, frm(data[i + 24:i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# ---------------------------------------------------------------------------
# bit streams
# ---------------------------------------------------------------------------


class _Backward:
    """A backward bit stream (RFC 8878 §4.1): read from the last byte's
    highest bit below its end marker down to bit 0 of the first byte.
    `pos` is the count of bits still unread; reads past the start yield
    zero bits and leave `pos` negative (an overflow)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        _need(len(data) > 0, "empty bit stream")
        last = data[-1]
        _need(last != 0, "bit stream without its end marker")
        self.data = bytes(data)
        self.pos = 8 * (len(data) - 1) + last.bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.pos
        start = pos - n
        self.pos = start
        if start >= 0:
            return (int.from_bytes(self.data[start >> 3:((pos - 1) >> 3) + 1], "little")
                    >> (start & 7)) & ((1 << n) - 1)
        if pos <= 0:
            return 0
        return (int.from_bytes(self.data[:((pos - 1) >> 3) + 1], "little")
                & ((1 << pos) - 1)) << -start


class _Forward:
    """Little-endian bits from the front of a byte string (the FSE table
    descriptions)."""

    def __init__(self, data: bytes, offset: int):
        self.data = data
        self.bit = 8 * offset

    def read(self, n: int) -> int:
        start, end = self.bit, self.bit + n
        _need(end <= 8 * len(self.data), "FSE table description overruns its input")
        self.bit = end
        return (int.from_bytes(self.data[start >> 3:((end - 1) >> 3) + 1], "little")
                >> (start & 7)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        start = self.bit
        chunk = self.data[start >> 3:((start + n - 1) >> 3) + 1]
        return (int.from_bytes(chunk, "little") >> (start & 7)) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------


def _read_fse_counts(data: bytes, offset: int, max_symbol: int, max_log: int):
    """An FSE table description (RFC 8878 §4.1.1): (normalized counts,
    accuracy log, bytes read)."""
    _need(offset < len(data), "missing FSE table description")
    bits = _Forward(data, offset)
    log = bits.read(4) + 5
    _need(log <= max_log, f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    norm = []
    while remaining > 1:
        _need(len(norm) <= max_symbol, "FSE table has too many symbols")
        limit = 2 * threshold - 1 - remaining
        low = bits.peek(nb - 1) if nb > 1 else 0
        if low < limit:
            value = bits.read(nb - 1)
        else:
            value = bits.read(nb)
            if value >= threshold:
                value -= limit
        count = value - 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        _need(remaining >= 1, "FSE counts exceed the table")
        if count == 0:
            while True:
                rep = bits.read(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
            _need(len(norm) <= max_symbol + 1, "FSE table has too many symbols")
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    _need(remaining == 1 and len(norm) <= max_symbol + 1, "malformed FSE table description")
    return norm, log, (bits.bit + 7) // 8 - offset


def _fse_table(norm, log: int):
    """Decoding table: per state, (symbol, bits to read, baseline)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(norm):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(c if c > 0 else 0):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    _need(pos == 0, "FSE counts do not fill the table")
    table = []
    for s in symbols:
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table, log


def _rle_table(symbol: int):
    return [(symbol, 0, 0)], 0


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------


def _huffman_table(data: bytes, offset: int):
    """A Huffman tree description (RFC 8878 §4.2.1): ((table, max bits),
    bytes read). The table maps a max_bits-bit peek to (symbol, bits)."""
    _need(offset < len(data), "missing Huffman tree description")
    head = data[offset]
    if head < 128:
        counts["huffman_weights_fse"] += 1
        end = offset + 1 + head
        _need(head > 0 and end <= len(data), "truncated Huffman weights")
        norm, log, used = _read_fse_counts(data[:end], offset + 1, 255, 6)
        table, log = _fse_table(norm, log)
        bits = _Backward(data[offset + 1 + used:end])
        s1, s2 = bits.read(log), bits.read(log)
        weights = []
        while True:
            _need(len(weights) < 255, "too many Huffman weights")
            sym, nb, base = table[s1]
            weights.append(sym)
            s1 = base + bits.read(nb)
            if bits.pos < 0:
                weights.append(table[s2][0])
                break
            _need(len(weights) < 255, "too many Huffman weights")
            sym, nb, base = table[s2]
            weights.append(sym)
            s2 = base + bits.read(nb)
            if bits.pos < 0:
                weights.append(table[s1][0])
                break
        used = 1 + head
    else:
        counts["huffman_weights_direct"] += 1
        n = head - 127
        used = 1 + (n + 1) // 2
        _need(offset + used <= len(data), "truncated Huffman weights")
        weights = []
        for i in range(n):
            byte = data[offset + 1 + i // 2]
            weights.append(byte >> 4 if i % 2 == 0 else byte & 15)
    _need(all(w <= 11 for w in weights), "Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    _need(total > 0, "Huffman weights are all zero")
    max_bits = total.bit_length()
    _need(max_bits <= 11, "Huffman code longer than 11 bits")
    rest = (1 << max_bits) - total
    _need(rest & (rest - 1) == 0, "Huffman weights do not complete a tree")
    weights.append(rest.bit_length())
    _need(len(weights) <= 256, "too many Huffman symbols")
    rank_start = [0] * (max_bits + 2)
    n_of = [0] * (max_bits + 2)
    for w in weights:
        n_of[w] += 1
    acc = 0
    for w in range(1, max_bits + 1):
        rank_start[w] = acc
        acc += n_of[w] << (w - 1)
    table = [None] * (1 << max_bits)
    for sym, w in enumerate(weights):
        if w:
            length = 1 << (w - 1)
            entry = (sym, max_bits + 1 - w)
            start = rank_start[w]
            table[start:start + length] = [entry] * length
            rank_start[w] = start + length
    return (table, max_bits), used


def _huffman_stream(stream: bytes, tree, n: int) -> bytes:
    table, max_bits = tree
    bits = _Backward(stream)
    data, pos = bits.data, bits.pos
    out = bytearray(n)
    frm = int.from_bytes
    mask = (1 << max_bits) - 1
    for i in range(n):
        start = pos - max_bits
        if start >= 0:
            peek = (frm(data[start >> 3:((pos - 1) >> 3) + 1], "little") >> (start & 7)) & mask
        elif pos > 0:
            peek = (frm(data[:((pos - 1) >> 3) + 1], "little") & ((1 << pos) - 1)) << -start
        else:
            peek = 0
        sym, nb = table[peek]
        out[i] = sym
        pos -= nb
    _need(pos == 0, "Huffman stream not consumed exactly")
    return bytes(out)


def _huffman_literals(body: bytes, tree, size: int, streams: int) -> bytes:
    if streams == 1:
        return _huffman_stream(body, tree, size)
    _need(len(body) >= 6, "truncated literals jump table")
    s1, s2, s3 = (int.from_bytes(body[i:i + 2], "little") for i in (0, 2, 4))
    s4 = len(body) - 6 - s1 - s2 - s3
    _need(s4 >= 1 and min(s1, s2, s3) >= 1, "bad literals jump table")
    seg = (size + 3) // 4
    _need(size >= 3 * seg, "too few literals for four streams")
    out = []
    pos = 6
    for length, n in ((s1, seg), (s2, seg), (s3, seg), (s4, size - 3 * seg)):
        out.append(_huffman_stream(body[pos:pos + length], tree, n))
        pos += length
    return b"".join(out)


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               -1, -1, -1, -1, -1]

# (baseline, extra bits) per literal-length and match-length code
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]

# per symbol type: (default counts, default log, max symbol, max log)
_KINDS = {
    "ll": (_LL_DEFAULT, 6, 35, 9),
    "of": (_OF_DEFAULT, 5, 31, 8),
    "ml": (_ML_DEFAULT, 6, 52, 9),
}
_DEFAULT_TABLES = {}


def _default_table(kind: str):
    if kind not in _DEFAULT_TABLES:
        norm, log, _, _ = _KINDS[kind]
        _DEFAULT_TABLES[kind] = _fse_table(norm, log)
    return _DEFAULT_TABLES[kind]


_MODE_NAMES = ("seq_predefined", "seq_rle", "seq_fse_compressed", "seq_repeat")


class _FrameState:
    """What carries from one block of a frame to the next."""

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(block: bytes, state: _FrameState):
    """The literals section: (literals, bytes read)."""
    _need(len(block) >= 1, "empty compressed block")
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                                   # Raw, RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            _need(len(block) >= 2, "truncated literals header")
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            _need(len(block) >= 3, "truncated literals header")
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        _need(size <= BLOCK_SIZE_MAX, "literals larger than a block")
        if kind == 0:
            counts["literals_raw"] += 1
            _need(head + size <= len(block), "truncated raw literals")
            return bytes(block[head:head + size]), head + size
        counts["literals_rle"] += 1
        _need(head < len(block), "truncated RLE literals")
        return bytes([block[head]]) * size, head + 1
    head = (3, 3, 4, 5)[fmt]
    _need(len(block) >= head, "truncated literals header")
    v = int.from_bytes(block[:head], "little") >> 4
    bits = (10, 10, 14, 18)[fmt]
    size, csize = v & ((1 << bits) - 1), v >> bits
    streams = 1 if fmt == 0 else 4
    _need(size <= BLOCK_SIZE_MAX, "literals larger than a block")
    _need(head + csize <= len(block), "truncated compressed literals")
    body = block[head:head + csize]
    if kind == 2:
        state.huffman, used = _huffman_table(body, 0)
        body = body[used:]
        counts["literals_huffman_1" if streams == 1 else "literals_huffman_4"] += 1
    else:
        counts["literals_treeless"] += 1
        _need(state.huffman is not None, "treeless literals without a previous Huffman table")
    return _huffman_literals(body, state.huffman, size, streams), head + csize


def _sequences(block: bytes, pos: int, state: _FrameState):
    """The sequences section: a list of (literal length, offset, match
    length), with the repeat offsets resolved."""
    _need(pos < len(block), "missing sequences section")
    b0 = block[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        _need(pos + 2 <= len(block), "truncated sequence count")
        nseq, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        _need(pos + 3 <= len(block), "truncated sequence count")
        nseq, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        _need(pos == len(block), "bytes after an empty sequences section")
        return []
    _need(pos < len(block), "missing symbol compression modes")
    modes = block[pos]
    pos += 1
    _need(modes & 3 == 0, "reserved bits set in the symbol compression modes")
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        counts[_MODE_NAMES[mode]] += 1
        _, _, max_symbol, max_log = _KINDS[kind]
        if mode == 0:
            state.tables[kind] = _default_table(kind)
        elif mode == 1:
            _need(pos < len(block), "missing RLE symbol")
            _need(block[pos] <= max_symbol, "RLE symbol out of range")
            state.tables[kind] = _rle_table(block[pos])
            pos += 1
        elif mode == 2:
            norm, log, used = _read_fse_counts(block, pos, max_symbol, max_log)
            state.tables[kind] = _fse_table(norm, log)
            pos += used
        else:
            _need(state.tables[kind] is not None, "repeat mode without a previous table")
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = (
        state.tables["ll"], state.tables["of"], state.tables["ml"])
    bits = _Backward(block[pos:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    reps = state.reps
    out = []
    for i in range(nseq):
        ll_sym, ll_nb, ll_base = ll_t[ll_s]
        of_sym, of_nb, of_base = of_t[of_s]
        ml_sym, ml_nb, ml_base = ml_t[ml_s]
        _need(ll_sym < len(_LL_CODES) and ml_sym < len(_ML_CODES) and of_sym <= 31,
              "sequence code out of range")
        of_value = (1 << of_sym) + read(of_sym)
        base, nb = _ML_CODES[ml_sym]
        match = base + read(nb)
        base, nb = _LL_CODES[ll_sym]
        lit = base + read(nb)
        if of_value > 3:
            offset = of_value - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = of_value - 1 + (lit == 0)
            if idx == 0:
                offset = reps[0]
            elif idx == 3:
                offset = reps[0] - 1
                reps[:] = [offset, reps[0], reps[1]]
            else:
                offset = reps[idx]
                reps[:] = [offset, reps[0], reps[2] if idx == 1 else reps[1]]
            _need(offset > 0, "repeat offset of 0")
        out.append((lit, offset, match))
        if i + 1 < nseq:
            ll_s = ll_base + read(ll_nb)
            ml_s = ml_base + read(ml_nb)
            of_s = of_base + read(of_nb)
        _need(bits.pos >= 0, "sequence bit stream overrun")
    _need(bits.pos == 0, "sequence bit stream not consumed exactly")
    return out


def _compressed_block(block: bytes, out: bytearray, state: _FrameState, block_max: int,
                      limit: int) -> None:
    lits, pos = _literals(block, state)
    seqs = _sequences(block, pos, state)
    size = len(lits) + sum(m for _, _, m in seqs)
    _need(size <= block_max, "block decodes to more than the block maximum size")
    _need(len(out) + size <= limit, "output above max_output_size")
    lp = 0
    for lit, offset, match in seqs:
        _need(lp + lit <= len(lits), "sequence reads past its literals")
        out += lits[lp:lp + lit]
        lp += lit
        start = len(out) - offset
        _need(start >= 0, "match offset before the frame's start")
        if offset >= match:
            out += out[start:start + match]
        else:
            pattern = bytes(out[start:])
            out += (pattern * (match // offset + 1))[:match]
    out += lits[lp:]


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _frame_header(data: bytes):
    """(content size or None, window size, checksum flag, header bytes)."""
    _need(len(data) >= 5, "truncated frame header")
    fhd = data[4]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    _need(fhd & 0x08 == 0, "reserved bit set in the frame header")
    pos = 5
    window = log = None
    if not single:
        _need(len(data) > pos, "truncated frame header")
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[dict_flag]
    _need(len(data) >= pos + did_size, "truncated frame header")
    dict_id = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    _need(len(data) >= pos + fcs_size, "truncated frame header")
    content = None
    if fcs_size:
        content = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content += 256
    pos += fcs_size
    if single:
        window = content
    # a frame that declares no content is empty whatever else it names
    if content != 0:
        if log is not None:
            _need(log <= (WINDOW_LOG_MAX if content is None else WINDOW_LOG_MAX_SIZED),
                  "frame requires too large a window")
        if dict_id != 0:
            raise ValueError("zstd: frames that name a dictionary are not supported")
    return content, window, checksum, pos


def decompress(data: bytes, max_output_size: int = 0) -> bytes:
    """The first zstd frame of `data`, decoded (module docstring)."""
    data = bytes(data)
    _need(len(data) >= 4, "input shorter than a frame's magic number")
    magic = int.from_bytes(data[:4], "little")
    if magic & SKIPPABLE_MAGIC_MASK == SKIPPABLE_MAGIC:
        _need(len(data) >= 8, "truncated skippable frame header")
        if int.from_bytes(data[4:8], "little") == 0:
            return b""
        raise ValueError("zstd: input starts with a skippable frame")
    _need(magic == MAGIC, "bad magic number")
    content, window, checksum, pos = _frame_header(data)
    if content == 0:
        return b""
    if content is None:
        if max_output_size <= 0:
            raise ValueError("zstd: frame has no content size and no max_output_size")
        limit = max_output_size
    else:
        if max_output_size > 0 and content > max_output_size:
            raise ValueError(f"zstd: declared content size {content} above "
                             f"max_output_size {max_output_size}")
        limit = content
    counts["frame"] += 1
    block_max = min(window, BLOCK_SIZE_MAX)
    out = bytearray()
    state = _FrameState()
    while True:
        _need(len(data) >= pos + 3, "truncated block header")
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 3:
            raise ValueError("zstd: reserved block type")
        _need(size <= block_max, "block larger than the block maximum size")
        if kind == 1:
            counts["block_rle"] += 1
            _need(len(data) > pos, "truncated RLE block")
            _need(len(out) + size <= limit, "output above its limit")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            _need(len(data) >= pos + size, "truncated block")
            block = data[pos:pos + size]
            pos += size
            if kind == 0:
                counts["block_raw"] += 1
                _need(len(out) + size <= limit, "output above its limit")
                out += block
            else:
                counts["block_compressed"] += 1
                _compressed_block(block, out, state, block_max, limit)
        if last:
            break
    if content is not None:
        _need(len(out) == content, "decoded size differs from the declared content size")
    if checksum:
        _need(len(data) >= pos + 4, "truncated content checksum")
        counts["checksum"] += 1
        _need(int.from_bytes(data[pos:pos + 4], "little") == xxh64(bytes(out)) & 0xFFFFFFFF,
              "content checksum mismatch")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """One frame of Raw blocks (module docstring): single segment, the
    content size, no checksum."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        fcs_flag, fcs = 0, n.to_bytes(1, "little")
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fcs_flag, fcs = 2, n.to_bytes(4, "little")
    else:
        fcs_flag, fcs = 3, n.to_bytes(8, "little")
    out = [MAGIC.to_bytes(4, "little"), bytes([(fcs_flag << 6) | 0x20]), fcs]
    pos = 0
    while True:
        block = data[pos:pos + BLOCK_SIZE_MAX]
        pos += len(block)
        last = pos >= n
        out.append(((len(block) << 3) | int(last)).to_bytes(3, "little"))
        out.append(block)
        if last:
            break
    return b"".join(out)
