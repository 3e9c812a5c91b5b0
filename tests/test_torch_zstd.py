"""``rnet_torch.zstd`` (the port's Zstandard decoder) against ``zstandard``.

Frames that ``zstandard`` writes at levels -5, 1, 3 and 19, with and
without the content checksum, with and without the content size (a
streaming frame), over payloads of 0 bytes, 1 byte, 100 KB of random bytes
(raw blocks), 300 KB of float32 parameters (several blocks, Huffman
literals), 200 KB of repetitive text (long matches, repeat offsets) and a
small alphabet (Huffman weights given directly): each decodes to the same
bytes. Hand-made frames cover RLE literals, RLE and raw blocks, several
frames in a row and skippable frames (``zstandard`` decodes them to the
same bytes). Truncated and corrupted frames, a wrong checksum, reserved
bits and a dictionary ID raise ``ZstdError``; XXH64 matches ``xxhash``.
"""

import numpy as np
import pytest
import xxhash
import zstandard

from rnet_torch import zstd

_RS = np.random.RandomState(0)
PAYLOADS = {
    "empty": b"",
    "one_byte": b"\x07",
    "random_100k": _RS.bytes(100_000),
    "float32_params_300k": (_RS.standard_normal(75_000) * 0.05).astype(np.float32).tobytes(),
    "text_200k": b"".join(b"%s the %d %s object is left of the %s one; " % (
        _RS.choice([b"is", b"what", b"how many"]), _RS.randint(9), _RS.choice([b"red", b"blue", b"gray"]),
        _RS.choice([b"large", b"small"])) for _ in range(5000))[:200_000],
    "small_alphabet_5k": _RS.choice(6, 5000).astype(np.uint8).tobytes(),
}


def _frame(payload, level, checksum, content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=content_size)
    if content_size:
        return c.compress(payload)
    co = c.compressobj()  # streaming: the header carries no content size
    return co.compress(payload) + co.flush()


@pytest.mark.parametrize("content_size", [True, False], ids=["sized", "streamed"])
@pytest.mark.parametrize("checksum", [False, True], ids=["nocheck", "checksum"])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("name", list(PAYLOADS))
def test_decodes_zstandard_frames(name, level, checksum, content_size):
    payload = PAYLOADS[name]
    frame = _frame(payload, level, checksum, content_size)
    assert zstd.decompress(frame) == payload


def _block(kind, content, size=None, last=True):
    size = len(content) if size is None else size
    return (int(last) | kind << 1 | size << 3).to_bytes(3, "little") + content


def _handmade(blocks, fhd=0x20, size=None):
    """A frame of ``blocks``: single-segment with a 1-byte content size by
    default."""
    head = zstd.FRAME_MAGIC.to_bytes(4, "little") + bytes([fhd])
    if fhd & 0x20:
        head += bytes([size])
    return head + b"".join(blocks)


def test_handmade_frames_match_zstandard():
    """RLE literals (a compressed block with no sequences), RLE and raw
    blocks, two frames in a row with a skippable frame between."""
    rle_literals = _block(2, bytes([1 | 1 << 2 | (100 & 15) << 4, 100 >> 4]) + b"q" + b"\x00")
    f1 = _handmade([rle_literals], size=100)
    f2 = _handmade([_block(0, b"raw bytes", last=False), _block(1, b"z", size=40)], size=49)
    skip = (zstd.SKIPPABLE_MAGIC | 3).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    data = f1 + skip + f2
    want = b"q" * 100 + b"raw bytes" + b"z" * 40
    assert zstandard.ZstdDecompressor().decompressobj().decompress(f1) == b"q" * 100
    assert zstd.decompress(data) == want
    assert zstd.decompress(b"".join(_frame(p, 3, True, True) for p in (b"abc" * 50, b"", b"xyz"))) == b"abc" * 50 + b"xyz"


def test_corrupted_frames_raise():
    payload = PAYLOADS["float32_params_300k"][:60_000] + PAYLOADS["text_200k"][:60_000]
    frame = _frame(payload, 3, True, True)
    for cut in (3, 7, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])
    wrong_checksum = frame[:-4] + bytes([frame[-4] ^ 0x10]) + frame[-3:]
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(wrong_checksum)
    rs = np.random.RandomState(1)
    for i in rs.randint(6, len(frame) - 4, 40):  # a flipped bit past the header: malformed or a checksum miss
        bad = bytearray(frame)
        bad[i] ^= 1 << rs.randint(8)
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError, match="not a Zstandard frame"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(zstd.ZstdError, match="reserved bit"):
        zstd.decompress(frame[:4] + bytes([frame[4] | 0x08]) + frame[5:])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(_handmade([_block(0, b"ab")], fhd=0x21, size=2))
    with pytest.raises(zstd.ZstdError, match="reserved block type"):
        zstd.decompress(_handmade([_block(3, b"")], size=0))


def test_xxh64_matches_xxhash():
    rs = np.random.RandomState(2)
    for n in (0, 1, 3, 4, 7, 8, 9, 31, 32, 33, 63, 64, 100, 1000, 100_003):
        data = rs.bytes(n)
        for seed in (0, 2**64 - 1):
            assert zstd.xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed), (n, seed)
