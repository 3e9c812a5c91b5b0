"""Read rnet's orbax epoch directories without JAX, orbax or tensorstore.

``rnet/train/checkpoint.py::CheckpointManager.save`` writes each epoch with
``ocp.StandardCheckpointer`` (orbax) into ``<name>_epoch_NNN/``: tensorstore's
OCDBT key-value store holding one zarr v2 array per leaf, and a
``_METADATA`` JSON naming the leaves. ``restore(path)`` returns what
``ocp.StandardCheckpointer().restore(path)`` returns without a target
(``rnet/train/checkpoint.py:165``): the nested tree, dicts for dict keys and
lists for sequence indices, the empty containers orbax records as such,
and numpy arrays for leaves (a ``bfloat16`` leaf, which numpy cannot hold,
as a ``torch.bfloat16`` tensor of the same bits). Three layers:

- **OCDBT** (``read_kvstore``): the root ``manifest.ocdbt`` names the
  latest version's B-tree root (following version-tree nodes when the
  manifest does not hold it inline); interior and leaf nodes are walked,
  keys rebuilt from their prefix compression and the subtree prefixes
  parents strip, values taken inline or from ``(data file, offset,
  length)``. orbax's per-process trees (``ocdbt.process_N/``) are reached
  through the root tree's data file paths, as tensorstore reaches them.
  Every manifest and node carries a header (magic, length, format version
  0, compression none or zstd) and a CRC-32C, both checked.
- **zarr v2** (``read_array``): ``<leaf>/.zarray`` (little-endian numpy
  dtypes and ``bfloat16``, C order, compressor ``zstd`` or none, the
  fill value, the ``.`` or ``/`` separator) and its chunks, ``0`` for a
  0-d array; a missing chunk is the fill value.
- **the orbax tree** (``restore``): ``_METADATA``'s ``tree_metadata``,
  each leaf checked against its ``write_shape``.

Anything else raises ``CheckpointFormatError`` naming it (zarr3, a
numbered manifest, an unknown format version, compression, zarr dtype or
compressor, a data file path leaving the directory); nothing is guessed.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict

import numpy as np

from .zstd import decompress as zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234


class CheckpointFormatError(ValueError):
    """A checkpoint directory this reader cannot read, and why."""


# ---------------------------------------------------------------------------
# Bytes: CRC-32C, the blob header, varints
# ---------------------------------------------------------------------------


def _crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c, t = 0xFFFFFFFF, _CRC32C
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CheckpointFormatError(f"truncated {self.what}")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise CheckpointFormatError(f"overlong varint in {self.what}")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise CheckpointFormatError(f"{len(self.data) - self.pos} unread bytes at the end of {self.what}")


def _blob(data: bytes, magic: int, what: str) -> _Reader:
    """The payload of a manifest or node: magic (u32 big-endian), total
    length (u64), format version (varint, 0), compression (varint: 0 none,
    1 zstd), the payload, CRC-32C of everything before it (u32)."""
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        raise CheckpointFormatError(f"{what}: not an OCDBT {what.split()[0]} (magic {data[:4].hex()})")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise CheckpointFormatError(f"{what}: length field disagrees with its {len(data)} bytes")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise CheckpointFormatError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise CheckpointFormatError(f"{what}: unknown OCDBT format version {version}")
    compression = r.varint()
    body = data[r.pos : -4]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise CheckpointFormatError(f"{what}: unknown OCDBT compression {compression}")
    return _Reader(body, what)


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


class _Store:
    """The files of one OCDBT directory, each read once."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.files: Dict[str, bytes] = {}

    def read(self, rel: str, offset: int = 0, length: int = -1) -> bytes:
        if not rel:  # the table's empty path: the location of nothing
            raise CheckpointFormatError(f"{self.root}: a node or value refers to the empty data file path")
        if rel not in self.files:
            with open(os.path.join(self.root, rel), "rb") as f:
                self.files[rel] = f.read()
        data = self.files[rel]
        if length < 0:
            return data
        if offset + length > len(data):
            raise CheckpointFormatError(f"{rel}: range {offset}+{length} past its {len(data)} bytes")
        return data[offset : offset + length]


def _data_files(r: _Reader) -> list:
    """A data file table: paths relative to the store's root, each the
    previous one's first ``prefix`` bytes and its own suffix (an empty path
    stands for no file: an empty tree's root)."""
    n = r.varint()
    prefix, suffix, base = r.varints(max(n - 1, 0)), r.varints(n), r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        path = (prev[: prefix[i - 1]] if i else b"") + r.take(suffix[i])
        text = path.decode()
        parts = text.split("/")
        if base[i] > len(path) or text.startswith("/") or ".." in parts or (text and "" in parts):
            raise CheckpointFormatError(f"{r.what}: data file path {text!r} leaves the checkpoint directory")
        paths.append(text)
        prev = path
    return paths


def _version_leaves(r: _Reader, files: list) -> list:
    """Version entries: (generation, root height, (file, offset, length))."""
    n = r.varint()
    gens = r.varints(n)
    heights = [r.byte() for _ in range(n)]
    locs = _locations(r, files, n)
    r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
    [r.u64() for _ in range(n)]  # commit times
    return list(zip(gens, heights, locs))


def _locations(r: _Reader, files: list, n: int) -> list:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    for i in ids:
        if i >= len(files):
            raise CheckpointFormatError(f"{r.what}: data file id {i} past its table of {len(files)}")
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _latest_root(store: _Store):
    """(root height, root location or None for an empty tree) of the
    manifest's latest version."""
    r = _blob(store.read("manifest.ocdbt"), MANIFEST_MAGIC, "manifest.ocdbt")
    r.take(16)  # uuid
    kind = r.varint()
    if kind != 0:
        raise CheckpointFormatError(f"manifest.ocdbt: manifest kind {kind} (numbered manifests) is not read")
    r.varint()  # max inline value bytes
    r.varint()  # max decoded node bytes
    r.byte()  # version tree arity log2
    compression = r.varint()
    if compression == 1:
        r.take(4)  # zstd level
    elif compression != 0:
        raise CheckpointFormatError(f"manifest.ocdbt: unknown compression method {compression}")
    files = _data_files(r)
    versions = _version_leaves(r, files)
    n = r.varint()
    gens = r.varints(n)
    locs = _locations(r, files, n)
    r.varints(n)  # generations under each node
    [r.u64() for _ in range(n)]  # commit times
    heights = [r.byte() for _ in range(n)]
    r.end()
    if versions:
        latest = max(versions)
    elif n:
        latest = _version_node(store, *max(zip(gens, heights, locs)))
    else:
        raise CheckpointFormatError("manifest.ocdbt records no version")
    _, height, loc = latest
    return height, (loc if loc[2] else None)


def _version_node(store: _Store, gen: int, height: int, loc):
    """The latest version under a version-tree node."""
    path, offset, length = loc
    r = _blob(store.read(path, offset, length), VERSION_TREE_MAGIC, f"version tree node {path}@{offset}")
    r.byte()  # arity log2
    if r.byte() != height:
        raise CheckpointFormatError(f"{r.what}: height disagrees with its reference")
    files = _data_files(r)
    if height == 0:
        versions = _version_leaves(r, files)
        r.end()
        return max(versions)
    n = r.varint()
    gens = r.varints(n)
    locs = _locations(r, files, n)
    r.varints(n)  # generations under each child
    [r.u64() for _ in range(n)]
    r.end()
    g, child = max(zip(gens, locs))
    return _version_node(store, g, height - 1, child)


def _keys(r: _Reader, n: int, interior: bool):
    prefix, suffix = r.varints(max(n - 1, 0)), r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        prev = (prev[: prefix[i - 1]] if i else b"") + r.take(suffix[i])
        keys.append(prev)
    return keys, common


def _walk(store: _Store, loc, height: int, prefix: bytes, out: Dict[str, bytes]) -> None:
    path, offset, length = loc
    r = _blob(store.read(path, offset, length), BTREE_MAGIC, f"B-tree node {path}@{offset}")
    if r.byte() != height:
        raise CheckpointFormatError(f"{r.what}: height disagrees with its parent's")
    files = _data_files(r)
    n = r.varint()
    keys, common = _keys(r, n, interior=height > 0)
    if height > 0:
        children = _locations(r, files, n)
        r.varints(3 * n)  # statistics
        r.end()
        for key, c, child in zip(keys, common, children):
            _walk(store, child, height - 1, prefix + key[:c], out)
        return
    lengths = r.varints(n)
    kinds = r.varints(n)
    if any(k > 1 for k in kinds):
        raise CheckpointFormatError(f"{r.what}: unknown value kind {max(kinds)}")
    m = sum(kinds)
    ids, offsets = r.varints(m), r.varints(m)
    indirect = iter(zip(ids, offsets))
    for key, ln, kind in zip(keys, lengths, kinds):
        if kind == 0:
            value = r.take(ln)
        else:
            i, o = next(indirect)
            if i >= len(files):
                raise CheckpointFormatError(f"{r.what}: data file id {i} past its table of {len(files)}")
            value = store.read(files[i], o, ln)
        out[(prefix + key).decode()] = value
    r.end()


def read_kvstore(root: str) -> Dict[str, bytes]:
    """Every key and value of the OCDBT store at ``root``, at its latest
    version."""
    store = _Store(root)
    height, loc = _latest_root(store)
    out: Dict[str, bytes] = {}
    if loc is not None:
        _walk(store, loc, height, b"", out)
    return out


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------


def _zarr_dtype(spec):
    if spec == "bfloat16":
        return "bfloat16"
    try:
        dt = np.dtype(spec)
    except TypeError:
        dt = None
    if not isinstance(spec, str) or dt is None or dt.kind not in "biufc" or dt.byteorder == ">":
        raise CheckpointFormatError(f"unknown zarr dtype {spec!r} (little-endian numeric numpy types and bfloat16 are read)")
    return dt


def _fill(value, dtype, npdtype):
    """The zarr fill value as a scalar of the stored dtype (None: none)."""
    if value is None:
        return None
    if isinstance(value, str):
        if value not in ("NaN", "Infinity", "-Infinity"):
            raise CheckpointFormatError(f"unknown zarr fill value {value!r}")
        value = float(value.replace("Infinity", "inf"))
    if dtype == "bfloat16":
        import torch

        return np.uint16(torch.tensor(float(value), dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF)
    return npdtype.type(value)


def read_array(kv: Dict[str, bytes], name: str):
    """The zarr v2 array ``name`` of an OCDBT key-value map: a numpy array,
    or a ``torch.bfloat16`` tensor for dtype ``bfloat16``."""
    key = f"{name}/.zarray"
    if key not in kv:
        raise CheckpointFormatError(f"the checkpoint has no array {name!r} ({key} missing)")
    meta = json.loads(kv[key])
    if meta.get("zarr_format") != 2:
        raise CheckpointFormatError(f"{key}: zarr_format {meta.get('zarr_format')!r} (2 is read)")
    if meta.get("order", "C") != "C":
        raise CheckpointFormatError(f"{key}: order {meta['order']!r} (C is read)")
    if meta.get("filters"):
        raise CheckpointFormatError(f"{key}: filters {meta['filters']!r} (none are read)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise CheckpointFormatError(f"{key}: unknown zarr compressor {comp.get('id')!r} (zstd or none is read)")
    dtype = _zarr_dtype(meta["dtype"])
    npdtype = np.dtype("<u2") if dtype == "bfloat16" else dtype
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise CheckpointFormatError(f"{key}: chunks {chunks} do not fit shape {shape}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise CheckpointFormatError(f"{key}: unknown dimension separator {sep!r}")
    fill = _fill(meta.get("fill_value"), dtype, npdtype)
    out = np.empty(shape, npdtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        ckey = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        raw = kv.get(ckey)
        if raw is None:
            if fill is None:
                raise CheckpointFormatError(f"chunk {ckey} is missing and {key} has no fill value")
            chunk = np.full(chunks, fill, npdtype)
        else:
            if comp is not None:
                raw = zstd_decompress(raw)
            if len(raw) != int(np.prod(chunks)) * npdtype.itemsize:
                raise CheckpointFormatError(f"chunk {ckey}: {len(raw)} bytes for a chunk of {chunks} {meta['dtype']}")
            chunk = np.frombuffer(raw, npdtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    if dtype == "bfloat16":
        import torch

        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# The orbax tree
# ---------------------------------------------------------------------------

_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple, "NamedTuple": lambda: None}


def _insert(tree, keys, value) -> Any:
    """Put ``value`` at the path ``keys`` ((key, is_sequence) pairs) of
    ``tree``, creating dicts and lists on the way; returns the tree."""
    if not keys:
        return value
    (k, seq), rest = keys[0], keys[1:]
    if seq:
        tree = [] if tree is None else tree
        if not isinstance(tree, list):
            raise CheckpointFormatError(f"tree node at {k!r} is both a sequence and a dict")
        i = int(k)
        tree.extend([None] * (i + 1 - len(tree)))
        tree[i] = _insert(tree[i], rest, value)
    else:
        tree = {} if tree is None else tree
        if not isinstance(tree, dict):
            raise CheckpointFormatError(f"tree node at {k!r} is both a dict and a sequence")
        tree[k] = _insert(tree.get(k), rest, value)
    return tree


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def restore(path: str):
    """The tree of the orbax checkpoint directory ``path``, as
    ``ocp.StandardCheckpointer().restore(path)`` gives it without a target."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise CheckpointFormatError(f"{path} is not an orbax checkpoint directory (no _METADATA)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise CheckpointFormatError(f"{path}: zarr3 checkpoints (use_zarr3: true) are not read")
    if meta.get("use_ocdbt") is False:
        raise CheckpointFormatError(f"{path}: checkpoints without OCDBT (use_ocdbt: false) are not read")
    kv = read_kvstore(path)
    tree = None
    for entry in meta["tree_metadata"].values():
        keys = []
        for k in entry["key_metadata"]:
            if k["key_type"] not in (1, 2):
                raise CheckpointFormatError(f"{path}: unknown key type {k['key_type']!r}")
            keys.append((str(k["key"]), k["key_type"] == 1))
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            empty = _EMPTY.get(value["value_type"])
            if empty is None:
                raise CheckpointFormatError(f"{path}: unknown empty value type {value['value_type']!r}")
            leaf = empty()
        else:
            name = ".".join(k for k, _ in keys)
            leaf = read_array(kv, name)
            if tuple(leaf.shape) != tuple(value.get("write_shape", leaf.shape)):
                raise CheckpointFormatError(f"{path}: {name} has shape {tuple(leaf.shape)}, _METADATA says "
                                            f"{tuple(value['write_shape'])}")
        tree = _insert(tree, keys, leaf)
    return _sorted(tree)
