"""Zstandard frame decoder (RFC 8878) in Python and numpy.

No ``rnet`` counterpart: rnet's orbax checkpoints compress twice with
Zstandard (each OCDBT node and manifest, and each zarr chunk), and the
port reads them without the ``zstandard`` package, which neither JAX's
nor the card's installation has to provide. ``decompress(data)`` returns
the concatenated content of every frame in ``data``:

- frame header: window descriptor, frame content size (checked), the
  single-segment flag; a dictionary ID raises (no dictionary is known);
- raw, RLE and compressed blocks;
- literals: raw, RLE, Huffman-coded with one or four streams (the tree
  given directly or FSE-compressed), and treeless (the frame's previous
  tree);
- sequences: predefined, RLE, FSE-compressed and repeat table modes, the
  three repeat offsets, executed against the frame's whole output;
- skippable frames are passed over;
- the XXH64 content checksum is checked when the frame carries one.

Anything malformed raises ``ZstdError``. The Huffman streams are decoded
with numpy (every bit position's table entry at once, then the chain of
decoded positions by composed jumps); FSE sequences are a Python loop.
This is host code for restoring checkpoints, at a few MB/s.
"""

from __future__ import annotations

import numpy as np

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50  # low 4 bits free
BLOCK_MAX = 128 * 1024


class ZstdError(ValueError):
    """A malformed or unsupported Zstandard frame."""


def _le(buf, pos: int, n: int) -> int:
    if pos + n > len(buf):
        raise ZstdError("truncated frame")
    return int.from_bytes(buf[pos : pos + n], "little")


# ---------------------------------------------------------------------------
# Bit streams
# ---------------------------------------------------------------------------


class _Backward:
    """The backward bit stream of FSE and Huffman data: the last byte's
    highest set bit marks the end, and reads take the most recently written
    bits first. Bits read past the start are zeros; ``pos`` < 0 then."""

    def __init__(self, buf):
        if not buf or buf[-1] == 0:
            raise ZstdError("bit stream without its end marker")
        self.buf = bytes(buf)
        self.pos = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p >= 0:
            b = p >> 3
            return (int.from_bytes(self.buf[b : b + 8], "little") >> (p & 7)) & ((1 << n) - 1)
        hi = p + n
        if hi <= 0:
            return 0
        return (int.from_bytes(self.buf[:8], "little") & ((1 << hi) - 1)) << (-p)


# ---------------------------------------------------------------------------
# FSE tables
# ---------------------------------------------------------------------------


def _read_ncount(buf, pos: int, max_symbol: int, max_log: int):
    """An FSE table description at ``buf[pos:]``: (normalized counts,
    accuracy log, position after it)."""
    v = int.from_bytes(buf[pos : pos + 512], "little")
    log = (v & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above the limit {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: list = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if prev0:
            n0 = len(norm)
            while True:
                r = (v >> bit) & 3
                bit += 2
                n0 += r
                if r != 3:
                    break
            if n0 > max_symbol:
                raise ZstdError("FSE zero run past the last symbol")
            norm.extend([0] * (n0 - len(norm)))
        mx = (2 * threshold - 1) - remaining
        low = (v >> bit) & (threshold - 1)
        if low < mx:
            count = low
            bit += nbits - 1
        else:
            count = (v >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        if remaining < 1:
            raise ZstdError("FSE counts exceed the table")
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("FSE counts do not fill the table")
    end = pos + ((bit + 7) >> 3)
    if end > len(buf):
        raise ZstdError("truncated FSE table description")
    return norm, log, end


def _fse_table(norm, log: int):
    """The decoding table of normalized counts: (log, symbol, bits, base)
    per state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("FSE counts do not spread over the table")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        n = log - (x.bit_length() - 1)
        nb[u] = n
        base[u] = (x << n) - size
    return log, sym, nb, base


# the predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               -1, -1, -1, -1, -1]
_PREDEFINED = {"literal lengths": _fse_table(_LL_DEFAULT, 6), "offsets": _fse_table(_OF_DEFAULT, 5),
               "match lengths": _fse_table(_ML_DEFAULT, 6)}
_MAX_SYMBOL = {"literal lengths": 35, "offsets": 31, "match lengths": 52}
_MAX_LOG = {"literal lengths": 9, "offsets": 8, "match lengths": 9}

# (baseline, extra bits) of each literal-length and match-length code
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------


def _fse_weights(buf):
    """Huffman weights compressed with FSE: two interleaved states over one
    backward stream, until it runs out."""
    norm, log, p = _read_ncount(buf, 0, 255, 6)
    _, sym, nb, base = _fse_table(norm, log)
    br = _Backward(buf[p:])
    s1, s2 = br.read(log), br.read(log)
    out = []
    while len(out) < 255:
        out.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.pos < 0:
            out.append(sym[s2])
            return out
        out.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.pos < 0:
            out.append(sym[s1])
            return out
    raise ZstdError("more than 255 Huffman weights")


def _huffman_table(body):
    """The Huffman tree description at the start of ``body``: ((max bits,
    symbol per peek value, code length per peek value), bytes used)."""
    if not body:
        raise ZstdError("missing Huffman tree description")
    hb = body[0]
    if hb < 128:
        if 1 + hb > len(body):
            raise ZstdError("truncated Huffman weights")
        weights, used = _fse_weights(body[1 : 1 + hb]), 1 + hb
    else:
        n = hb - 127
        used = 1 + (n + 1) // 2
        if used > len(body):
            raise ZstdError("truncated Huffman weights")
        weights = [(body[1 + i // 2] >> 4) if i % 2 == 0 else (body[1 + i // 2] & 15) for i in range(n)]
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights are all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if max_bits > 11 or left & (left - 1):
        raise ZstdError("Huffman weights do not complete a tree")
    weights.append(left.bit_length())
    start, p = [0] * 13, 0
    for w in range(1, max_bits + 1):
        start[w] = p
        p += weights.count(w) << (w - 1)
    sym = np.zeros(1 << max_bits, np.uint8)
    nbits = np.zeros(1 << max_bits, np.int32)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            sym[start[w] : start[w] + n] = s
            nbits[start[w] : start[w] + n] = max_bits + 1 - w
            start[w] += n
    return (max_bits, sym, nbits), used


_HOP = 8  # decoded positions between the coarse walk's stops


def _peek(data, end: int, max_bits: int) -> np.ndarray:
    """The max_bits stream bits below each position 0 .. end, first bit
    highest, bits below the start zero: for positions 8k + r they are the
    24-bit words at byte k + c_r shifted by s_r, eight slices in all."""
    k = (end + 8) // 8
    pad = np.zeros(k + 4, np.int32)  # stream bit q is bit q + 16 here
    pad[2 : 2 + len(data)] = np.frombuffer(bytes(data), np.uint8)
    words = pad[:-2] | (pad[1:-1] << 8) | (pad[2:] << 16)
    out = np.empty((k, 8), np.int32)
    for r in range(8):
        c, s = (r + 16 - max_bits) >> 3, (r + 16 - max_bits) & 7
        np.bitwise_and(words[c : c + k] >> s, (1 << max_bits) - 1, out=out[:, r])
    return out.reshape(-1)[: end + 1]


def _huffman_stream(data, table, n: int) -> bytes:
    """``n`` symbols of one backward Huffman stream, which they must use up
    exactly. The peek value, and so the code length, is computed for every
    bit position at once; the decoded positions p_0 = end, p_k+1 = p_k -
    length(p_k) then follow from a walk over every _HOP-th of them (the
    next-position map composed _HOP times), filled in by _HOP - 1 gathers."""
    max_bits, sym, nbits = table
    if not data or data[-1] == 0:
        raise ZstdError("Huffman stream without its end marker")
    end = (len(data) - 1) * 8 + data[-1].bit_length() - 1
    peek = _peek(data, end, max_bits)
    nxt = np.empty(end + 2, np.int32)  # the last entry, index -1, is a read past the start
    np.subtract(np.arange(end + 1, dtype=np.int32), np.take(nbits, peek), out=nxt[:-1])
    np.maximum(nxt, -1, out=nxt)
    nxt[-1] = -1
    hop = nxt
    for _ in range(_HOP.bit_length() - 1):
        hop = np.take(hop, hop)
    p, stops = end, [end]
    for _ in range(n // _HOP):
        p = hop[p]
        stops.append(p)
    rows = [np.array(stops, np.int32)]
    for _ in range(_HOP - 1):
        rows.append(np.take(nxt, rows[-1]))
    path = np.stack(rows, axis=1).reshape(-1)[: n + 1]
    if path[-1] != 0 or (path < 0).any():
        raise ZstdError("corrupted Huffman stream")
    return np.take(sym, np.take(peek, path[:-1])).tobytes()


def _literals(block, st):
    """The literals section: (literals, bytes used)."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, h = b0 >> 3, 1
        elif fmt == 1:
            size, h = (b0 >> 4) + (_le(block, 1, 1) << 4), 2
        else:
            size, h = (b0 >> 4) + (_le(block, 1, 2) << 4), 3
        if kind == 0:
            if h + size > len(block):
                raise ZstdError("truncated raw literals")
            return bytes(block[h : h + size]), h + size
        return bytes([_le(block, h, 1)]) * size, h + 1
    if fmt in (0, 1):
        c, h, bits = _le(block, 0, 3), 3, 10
    elif fmt == 2:
        c, h, bits = _le(block, 0, 4), 4, 14
    else:
        c, h, bits = _le(block, 0, 5), 5, 18
    regen = (c >> 4) & ((1 << bits) - 1)
    comp = (c >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    if h + comp > len(block):
        raise ZstdError("truncated Huffman literals")
    body = block[h : h + comp]
    p = 0
    if kind == 2:
        st.huffman, p = _huffman_table(body)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman tree in the frame")
    body = body[p:]
    if streams == 1:
        return _huffman_stream(body, st.huffman, regen), h + comp
    if len(body) < 6:
        raise ZstdError("truncated Huffman jump table")
    sizes = [_le(body, 0, 2), _le(body, 2, 2), _le(body, 4, 2)]
    sizes.append(len(body) - 6 - sum(sizes))
    each = (regen + 3) // 4
    counts = [each, each, each, regen - 3 * each]
    if sizes[3] < 0 or counts[3] < 0:
        raise ZstdError("Huffman jump table does not fit its literals")
    out, q = [], 6
    for size, n in zip(sizes, counts):
        out.append(_huffman_stream(body[q : q + size], st.huffman, n))
        q += size
    return b"".join(out), h + comp


# ---------------------------------------------------------------------------
# Sequences and blocks
# ---------------------------------------------------------------------------


class _FrameState:
    """What blocks of one frame carry to the next: the Huffman tree, the
    three FSE tables and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = {}
        self.rep = [1, 4, 8]


def _table(block, pos: int, mode: int, kind: str, st):
    if mode == 0:
        table = _PREDEFINED[kind]
    elif mode == 1:
        s = _le(block, pos, 1)
        if s > _MAX_SYMBOL[kind]:
            raise ZstdError(f"RLE {kind} symbol {s} out of range")
        table, pos = (0, [s], [0], [0]), pos + 1
    elif mode == 2:
        norm, log, pos = _read_ncount(block, pos, _MAX_SYMBOL[kind], _MAX_LOG[kind])
        table = _fse_table(norm, log)
    else:
        table = st.tables.get(kind)
        if table is None:
            raise ZstdError(f"repeat {kind} table without an earlier one in the frame")
    st.tables[kind] = table
    return table, pos


def _compressed_block(block, out: bytearray, st) -> None:
    lits, pos = _literals(block, st)
    if len(lits) > BLOCK_MAX:
        raise ZstdError("a block decodes to more than 128 KiB")
    n = _le(block, pos, 1)
    if n == 0:
        if pos + 1 != len(block):
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    if n < 128:
        pos += 1
    elif n < 255:
        n, pos = ((n - 128) << 8) + _le(block, pos + 1, 1), pos + 2
    else:
        n, pos = _le(block, pos + 1, 2) + 0x7F00, pos + 3
    modes = _le(block, pos, 1)
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    (ll_log, ll_sym, ll_nb, ll_base), pos = _table(block, pos, modes >> 6, "literal lengths", st)
    (of_log, of_sym, of_nb, of_base), pos = _table(block, pos, (modes >> 4) & 3, "offsets", st)
    (ml_log, ml_sym, ml_nb, ml_base), pos = _table(block, pos, (modes >> 2) & 3, "match lengths", st)
    br = _Backward(block[pos:])
    read = br.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = st.rep
    lp, limit = 0, len(out) + BLOCK_MAX
    for i in range(n):
        of_code, ll_code, ml_code = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if of_code > 31:
            raise ZstdError(f"offset code {of_code} out of range")
        ofv = (1 << of_code) + read(of_code)
        base, bits = _ML_CODES[ml_code]
        ml = base + read(bits)
        base, bits = _LL_CODES[ll_code]
        ll = base + read(bits)
        if ofv > 3:
            off = ofv - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            k = ofv - 1 + (ll == 0)
            if k == 0:
                off = rep[0]
            elif k == 1:
                off = rep[1]
                rep[1], rep[0] = rep[0], off
            else:
                off = rep[2] if k == 2 else rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
        if i != n - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > len(lits):
            raise ZstdError("a sequence takes more literals than the block has")
        out += lits[lp : lp + ll]
        lp += ll
        if off < 1 or off > len(out):
            raise ZstdError(f"match offset {off} outside the frame's output")
        start = len(out) - off
        if len(out) + ml > limit:
            raise ZstdError("a block decodes to more than 128 KiB")
        if off >= ml:
            out += out[start : start + ml]
        else:  # the match overlaps its own output: repeat the last `off` bytes
            out += (out[start:] * (ml // off + 1))[:ml]
    if br.pos != 0:
        raise ZstdError("the sequences do not use up their bit stream")
    out += lits[lp:]
    if len(out) > limit:
        raise ZstdError("a block decodes to more than 128 KiB")


# ---------------------------------------------------------------------------
# XXH64 (the content checksum) and frames
# ---------------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        stripes = np.frombuffer(data[: n // 32 * 32], "<u8").reshape(-1, 4).tolist()
        for a, b, c, d in stripes:
            v[0], v[1], v[2], v[3] = _round(v[0], a), _round(v[1], b), _round(v[2], c), _round(v[3], d)
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        p = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[p : p + 8], "little")), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p : p + 4], "little") * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = _rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


def _frame(data, pos: int):
    """One frame after its magic number: (content, position after it)."""
    fhd = _le(data, pos, 1)
    pos += 1
    if fhd & 0x08:
        raise ZstdError("reserved bit set in the frame header")
    if fhd & 3:
        raise ZstdError("the frame names a dictionary (dictionary ID present); no dictionary is known")
    single = (fhd >> 5) & 1
    if not single:
        pos += 1  # window descriptor: the whole frame's output is kept as history
    fcs_size = (1 if single else 0, 2, 4, 8)[fhd >> 6]
    size = None
    if fcs_size:
        size = _le(data, pos, fcs_size) + (256 if fcs_size == 2 else 0)
        pos += fcs_size
    st = _FrameState()
    out = bytearray()
    while True:
        header = _le(data, pos, 3)
        pos += 3
        last, kind, bsize = header & 1, (header >> 1) & 3, header >> 3
        if bsize > BLOCK_MAX:
            raise ZstdError(f"block of {bsize} bytes above the 128 KiB limit")
        if kind == 0:
            if pos + bsize > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos : pos + bsize]
            pos += bsize
        elif kind == 1:
            out += bytes([_le(data, pos, 1)]) * bsize
            pos += 1
        elif kind == 2:
            if pos + bsize > len(data):
                raise ZstdError("truncated compressed block")
            _compressed_block(data[pos : pos + bsize], out, st)
            pos += bsize
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if size is not None and len(out) != size:
        raise ZstdError(f"frame content is {len(out)} bytes, its header says {size}")
    if fhd & 4:
        want = _le(data, pos, 4)
        pos += 4
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
    return out, pos


def decompress(data) -> bytes:
    """The content of every Zstandard frame in ``data``, concatenated;
    skippable frames are passed over."""
    data = bytes(data)
    if not data:
        raise ZstdError("no Zstandard frame")
    out, pos = bytearray(), 0
    while pos < len(data):
        magic = _le(data, pos, 4)
        if magic & 0xFFFFFFF0 == SKIPPABLE_MAGIC:
            pos += 8 + _le(data, pos + 4, 4)
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != FRAME_MAGIC:
            raise ZstdError(f"not a Zstandard frame (magic {magic:#010x})")
        content, pos = _frame(data, pos + 4)
        out += content
    return bytes(out)
