"""A reader of TensorFlow checkpoints in numpy alone (the port's
counterpart of ``py_checkpoint_reader``, which the JAX package's
``compat/tf_import.py::load_tf_checkpoint`` calls; no TensorFlow here).

Two formats, both built on the leveldb table that TensorFlow writes
(``tensorflow/core/lib/io/table``): a 48-byte footer (two block handles
as varints, zero padding, the magic ``0xdb4775248b80fb57``), blocks of
prefix-compressed entries (``shared``, ``non_shared`` and value length
as varints, then the key's new bytes and the value) with restart points,
each block followed by a 5-byte trailer (a compression type byte and the
masked crc32c of the block and that byte).

- **V2** (``tf.train.Saver`` V2, ``tf.train.Checkpoint``):
  ``<prefix>.index`` is the table, ``<prefix>.data-NNNNN-of-NNNNN`` the
  tensors' bytes. Key ``""`` holds the ``BundleHeaderProto`` (shard
  count, endianness); every other key is a tensor name whose value is a
  ``BundleEntryProto`` (dtype, shape, shard, offset, size, the masked
  crc32c of the bytes, and the slices of a partitioned tensor).
- **V1** (``Saver(write_version=V1)``): one file, the table alone. Key
  ``""`` holds a ``SavedTensorSlices`` whose ``meta`` lists every
  tensor (name, shape, dtype, slices); every other key holds a
  ``SavedTensorSlices`` whose ``data`` is one slice's values in a
  ``TensorProto`` (``tensor_content``, or the typed ``*_val`` fields).

The protobuf messages are decoded by hand. Types: float16/32/64,
bfloat16 (an ``ml_dtypes.bfloat16`` array where ``ml_dtypes`` is
installed, else widened to float32, which is exact), int8/16/32/64,
uint8, bool. String tensors are skipped by name.
Refused, with a ``ValueError`` that names what was found: a compressed
block, a sliced (partitioned) tensor, a crc mismatch (of a block or of a
tensor's bytes), a big-endian bundle, a type outside that list.

The crc32c (Castagnoli, reflected) is computed with numpy: the data cut
into 256-byte chunks whose register updates run side by side
(slicing-by-4 tables), the chunks' CRCs then joined pairwise by the
linear operator that shifts a register through 2^k·256 zero bytes.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5

# DataType enum (tensorflow/core/framework/types.proto) → numpy type
_DT_STRING = 7
_NUMPY_TYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
                5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
                19: np.float16}
_DT_BFLOAT16 = 14


# -- crc32c -------------------------------------------------------------------

_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8
_CHUNK_WORDS = 64  # 256-byte chunks


def _byte_tables() -> np.ndarray:
    t0 = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t0 = np.where(t0 & 1, (t0 >> 1) ^ np.uint32(_POLY), t0 >> 1)
    tables = [t0.astype(np.uint32)]
    for _ in range(3):
        prev = tables[-1]
        tables.append((prev >> 8) ^ t0[prev & 0xFF])
    return np.stack(tables)  # tables[k]: a byte k positions from the end


_T = _byte_tables()
# the register after one 4-byte word of zeros, by the byte of the register
_WORD_OP = np.stack([_T[3], _T[2], _T[1], _T[0]])


def _apply(op: np.ndarray, x: np.ndarray) -> np.ndarray:
    """A linear map of registers, given by its four 256-entry tables (one
    for each byte of the register), applied to an array of registers."""
    return (op[0][x & 0xFF] ^ op[1][(x >> 8) & 0xFF] ^
            op[2][(x >> 16) & 0xFF] ^ op[3][x >> 24])


def _tables_of(columns: np.ndarray) -> np.ndarray:
    """The four tables of the linear map whose image of bit k is
    ``columns[k]``."""
    op = np.zeros((4, 256), np.uint32)
    for j in range(4):
        for b in range(8):
            half = 1 << b
            op[j, half:2 * half] = op[j, :half] ^ columns[8 * j + b]
    return op


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The map ``a ∘ b``."""
    bits = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    return _tables_of(_apply(a, _apply(b, bits)))


def _chunk_op() -> np.ndarray:
    op = _WORD_OP
    for _ in range(6):  # 2^6 words = one chunk
        op = _compose(op, op)
    return op


_CHUNK_OP = _chunk_op()


def _words_raw(words: np.ndarray, reg: int) -> int:
    """The register after ``words`` (uint32, little-endian), one by one."""
    t = _T
    for w in words.tolist():
        reg ^= w
        reg = int(t[3][reg & 0xFF] ^ t[2][(reg >> 8) & 0xFF] ^
                  t[1][(reg >> 16) & 0xFF] ^ t[0][reg >> 24])
    return reg


def crc32c(data) -> int:
    """The crc32c of a bytes-like object or uint8 array (initial register
    and final xor 0xffffffff, as TensorFlow's ``crc32c::Value``)."""
    buf = np.frombuffer(memoryview(data), np.uint8)
    n_words = buf.size // 4
    words = buf[:n_words * 4].view("<u4").astype(np.uint32)
    reg = 0xFFFFFFFF
    if n_words:
        words[0] ^= np.uint32(reg)  # the initial register, folded in
        reg = 0
        n_chunks = n_words // _CHUNK_WORDS
        if n_chunks:
            cols = words[:n_chunks * _CHUNK_WORDS].reshape(
                n_chunks, _CHUNK_WORDS).T.copy()
            crcs = np.zeros(n_chunks, np.uint32)
            for w in cols:
                crcs ^= w
                crcs = (_T[3][crcs & 0xFF] ^ _T[2][(crcs >> 8) & 0xFF] ^
                        _T[1][(crcs >> 16) & 0xFF] ^ _T[0][crcs >> 24])
            # zero chunks in front change no register that starts at 0
            width = 1 << (n_chunks - 1).bit_length()
            crcs = np.concatenate(
                [np.zeros(width - n_chunks, np.uint32), crcs])
            op = _CHUNK_OP
            while crcs.size > 1:
                crcs = _apply(op, crcs[0::2]) ^ crcs[1::2]
                op = _compose(op, op)
            reg = int(crcs[0])
        reg = _words_raw(words[n_chunks * _CHUNK_WORDS:], reg)
    for byte in buf[n_words * 4:].tolist():
        reg = int(_T[0][(reg ^ byte) & 0xFF]) ^ (reg >> 8)
    return reg ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """TensorFlow's ``crc32c::Mask``: the stored form of a crc."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) \
        & 0xFFFFFFFF


# -- protobuf wire format -----------------------------------------------------


def _varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """(field number, wire type, value) of a message: an int for varint
    and fixed fields, bytes for length-delimited ones."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value = buf[pos:pos + size]
            pos += size
        elif wire == 5:
            value = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _signed(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _packed_varints(chunks: list, signed: bool) -> np.ndarray:
    """The values of repeated varint fields (packed chunks as bytes,
    single values as ints), decoded with numpy."""
    out = []
    for chunk in chunks:
        if isinstance(chunk, int):
            out.append(np.array([chunk], np.uint64))
            continue
        b = np.frombuffer(chunk, np.uint8)
        if b.size == 0:
            continue
        ends = np.flatnonzero(b < 0x80)
        starts = np.concatenate([[0], ends[:-1] + 1])
        group = np.repeat(np.arange(ends.size), ends - starts + 1)
        pos = np.arange(b.size) - starts[group]
        parts = (b & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
        out.append(np.bitwise_or.reduceat(parts, starts))
    values = np.concatenate(out) if out else np.zeros(0, np.uint64)
    return values.view(np.int64) if signed else values


def _shape(buf: bytes) -> tuple[int, ...]:
    """A ``TensorShapeProto``'s dims."""
    dims = []
    for field, _, value in _fields(buf):
        if field == 2:
            size = 0
            for f, _, v in _fields(value):
                if f == 1:
                    size = _signed(v)
            dims.append(size)
        elif field == 3 and value:
            raise ValueError("a tensor of unknown rank")
    return tuple(dims)


def _slice_is_full(buf: bytes, shape: tuple[int, ...]) -> bool:
    """Whether a ``TensorSliceProto`` covers the whole tensor: every
    extent without a length, or from 0 over the whole dimension."""
    extents = [dict((f, v) for f, _, v in _fields(e))
               for f, _, e in _fields(buf) if f == 1]
    if not extents:
        return True
    for dim, ext in zip(shape, extents):
        if 2 in ext and (ext.get(1, 0) != 0 or _signed(ext[2]) != dim):
            return False
    return True


# -- numpy types --------------------------------------------------------------


def _bfloat16_array(bits: np.ndarray) -> np.ndarray:
    """bfloat16 values from their 16-bit patterns: an ``ml_dtypes``
    array where that package is installed, else float32 (exact)."""
    bits = bits.astype(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return bits.view(ml_dtypes.bfloat16)


def _check_dtype(dtype: int, name: str) -> None:
    if dtype not in _NUMPY_TYPES and dtype != _DT_BFLOAT16:
        raise ValueError(f"tensor {name!r} has DataType {dtype}, which "
                         "this reader does not decode")


def _from_bytes(raw, dtype: int, shape: tuple[int, ...]) -> np.ndarray:
    if dtype == _DT_BFLOAT16:
        return _bfloat16_array(
            np.frombuffer(raw, "<u2").copy()).reshape(shape)
    t = np.dtype(_NUMPY_TYPES[dtype]).newbyteorder("<")
    return np.frombuffer(raw, t).astype(t.newbyteorder("="),
                                        copy=True).reshape(shape)


# -- the table ----------------------------------------------------------------


class _Table:
    """The entries of a leveldb-format table, in key order."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        if len(self.data) < FOOTER_BYTES:
            raise ValueError(f"{path}: {len(self.data)} bytes, shorter than "
                             "a table footer")
        footer = self.data[-FOOTER_BYTES:]
        magic = int.from_bytes(footer[-8:], "little")
        if magic != TABLE_MAGIC:
            raise ValueError(f"{path}: table magic {magic:#x}, not "
                             f"{TABLE_MAGIC:#x}: not a TF checkpoint table")
        _, pos = _varint(footer, 0)  # the metaindex handle: unused
        _, pos = _varint(footer, pos)
        offset, pos = _varint(footer, pos)
        size, _ = _varint(footer, pos)
        self.index = self._block(offset, size)

    def _block(self, offset: int, size: int) -> bytes:
        end = offset + size
        if end + BLOCK_TRAILER_BYTES > len(self.data):
            raise ValueError(f"{self.path}: block at {offset} runs past the "
                             "end of the file")
        kind = self.data[end]
        if kind != 0:
            raise ValueError(
                f"{self.path}: block at {offset} has compression type "
                f"{kind} ({ {1: 'snappy', 2: 'zstd'}.get(kind, 'unknown') }); "
                "only uncompressed tables are read")
        stored = int.from_bytes(self.data[end + 1:end + 5], "little")
        actual = mask_crc(crc32c(self.data[offset:end + 1]))
        if stored != actual:
            raise ValueError(f"{self.path}: block at {offset}: crc32c "
                             f"{actual:#010x}, stored {stored:#010x}")
        return self.data[offset:end]

    @staticmethod
    def _entries(block: bytes) -> Iterator[tuple[bytes, bytes]]:
        n_restarts = int.from_bytes(block[-4:], "little")
        limit = len(block) - 4 - 4 * n_restarts
        pos, key = 0, b""
        while pos < limit:
            shared, pos = _varint(block, pos)
            fresh, pos = _varint(block, pos)
            size, pos = _varint(block, pos)
            key = key[:shared] + block[pos:pos + fresh]
            pos += fresh
            yield key, block[pos:pos + size]
            pos += size

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        for _, handle in self._entries(self.index):
            offset, pos = _varint(handle, 0)
            size, _ = _varint(handle, pos)
            yield from self._entries(self._block(offset, size))


# -- V2 -----------------------------------------------------------------------


def _read_v2(prefix: str) -> dict[str, np.ndarray]:
    table = _Table(prefix + ".index")
    items = iter(table.items())
    header_key, header = next(items, (None, b""))
    if header_key != b"":
        raise ValueError(f"{prefix}.index: no bundle header")
    num_shards = 1
    for field, _, value in _fields(header):
        if field == 1:
            num_shards = value
        elif field == 2 and value != 0:
            raise ValueError(f"{prefix}.index: a big-endian bundle")
    shards: dict[int, np.memmap] = {}
    out: dict[str, np.ndarray] = {}
    slice_keys = 0
    for key, value in items:
        try:
            name = key.decode()
        except UnicodeDecodeError:  # an encoded (name, slice) key
            slice_keys += 1
            continue
        entry = {"dtype": 0, "shape": (), "shard": 0, "offset": 0,
                 "size": 0, "crc": None, "slices": 0}
        for field, _, v in _fields(value):
            if field == 1:
                entry["dtype"] = v
            elif field == 2:
                entry["shape"] = _shape(v)
            elif field == 3:
                entry["shard"] = v
            elif field == 4:
                entry["offset"] = v
            elif field == 5:
                entry["size"] = v
            elif field == 6:
                entry["crc"] = v
            elif field == 7:
                entry["slices"] += 1
        if entry["slices"]:
            raise ValueError(f"{prefix}: tensor {name!r} is sliced into "
                             f"{entry['slices']} partitions; sliced tensors "
                             "are not read")
        if entry["dtype"] == _DT_STRING:
            continue
        _check_dtype(entry["dtype"], name)
        shard = entry["shard"]
        if shard not in shards:
            path = f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"
            shards[shard] = (np.memmap(path, np.uint8, mode="r")
                             if os.path.getsize(path)
                             else np.zeros(0, np.uint8))
        start, size = entry["offset"], entry["size"]
        raw = shards[shard][start:start + size]
        if raw.size != size:
            raise ValueError(f"{prefix}: tensor {name!r} runs past the end "
                             f"of shard {shard}")
        if entry["crc"] is not None:
            actual = mask_crc(crc32c(raw))
            if actual != entry["crc"]:
                raise ValueError(f"{prefix}: tensor {name!r}: crc32c "
                                 f"{actual:#010x}, stored "
                                 f"{entry['crc']:#010x}")
        out[name] = _from_bytes(raw, entry["dtype"], entry["shape"])
    if slice_keys:
        raise ValueError(f"{prefix}: {slice_keys} entries of tensor slices; "
                         "sliced tensors are not read")
    return out


# -- V1 -----------------------------------------------------------------------

# TensorProto's typed value fields
_FLOAT_VAL, _DOUBLE_VAL, _INT_VAL, _INT64_VAL, _BOOL_VAL = 5, 6, 7, 10, 11
_HALF_VAL = 13


def _typed_values(fields: dict[int, list], dtype: int) -> np.ndarray:
    """The values of a ``TensorProto``'s typed field for ``dtype``."""
    def fixed(field: int, t: str) -> np.ndarray:
        chunks = []
        for c in fields.get(field, []):
            if isinstance(c, int):  # one unpacked value
                c = c.to_bytes(np.dtype(t).itemsize, "little")
            chunks.append(np.frombuffer(c, t))
        return np.concatenate(chunks) if chunks else np.zeros(0, t)

    if dtype == 1:
        return fixed(_FLOAT_VAL, "<f4")
    if dtype == 2:
        return fixed(_DOUBLE_VAL, "<f8")
    if dtype in (3, 4, 5, 6):
        return _packed_varints(fields.get(_INT_VAL, []), True)
    if dtype == 9:
        return _packed_varints(fields.get(_INT64_VAL, []), True)
    if dtype == 10:
        return _packed_varints(fields.get(_BOOL_VAL, []), False) != 0
    return _packed_varints(fields.get(_HALF_VAL, []), False)  # 16-bit


def _tensor_proto(buf: bytes, dtype: int, shape: tuple[int, ...],
                  name: str) -> np.ndarray:
    fields: dict[int, list] = {}
    for field, _, value in _fields(buf):
        fields.setdefault(field, []).append(value)
    if 4 in fields:  # tensor_content: the raw little-endian bytes
        return _from_bytes(b"".join(fields[4]), dtype, shape)
    values = _typed_values(fields, dtype)
    n = int(np.prod(shape, dtype=np.int64))
    if values.size > n:
        raise ValueError(f"tensor {name!r}: {values.size} values for shape "
                         f"{shape}")
    if values.size < n:  # TensorProto's rule: the last value repeats
        fill = values[-1] if values.size else 0
        values = np.concatenate(
            [values, np.full(n - values.size, fill, values.dtype)])
    if dtype == _DT_BFLOAT16:
        return _bfloat16_array(values).reshape(shape)
    if dtype == 19:
        return values.astype(np.uint16).view(np.float16).reshape(shape)
    return values.astype(_NUMPY_TYPES[dtype]).reshape(shape)


def _read_v1(path: str) -> dict[str, np.ndarray]:
    table = _Table(path)
    meta: dict[str, tuple[int, tuple[int, ...]]] = {}
    out: dict[str, np.ndarray] = {}
    for key, value in table.items():
        for field, _, body in _fields(value):
            if key == b"" and field == 1:  # meta: SavedTensorSliceMeta
                for f, _, tensor in _fields(body):
                    if f != 1:
                        continue
                    name, shape, dtype, slices = "", (), 0, []
                    for tf_, _, tv in _fields(tensor):
                        if tf_ == 1:
                            name = tv.decode()
                        elif tf_ == 2:
                            shape = _shape(tv)
                        elif tf_ == 3:
                            dtype = tv
                        elif tf_ == 4:
                            slices.append(tv)
                    if len(slices) != 1 or not _slice_is_full(slices[0],
                                                              shape):
                        raise ValueError(
                            f"{path}: tensor {name!r} is saved in "
                            f"{len(slices)} slice(s) that do not cover it "
                            "whole; sliced tensors are not read")
                    meta[name] = (dtype, shape)
            elif key != b"" and field == 2:  # data: SavedSlice
                name, proto = "", None
                for f, _, v in _fields(body):
                    if f == 1:
                        name = v.decode()
                    elif f == 3:
                        proto = v
                if name not in meta:
                    raise ValueError(f"{path}: data for {name!r}, which the "
                                     "meta record does not list")
                dtype, shape = meta[name]
                if dtype == _DT_STRING:
                    continue
                _check_dtype(dtype, name)
                out[name] = _tensor_proto(proto or b"", dtype, shape, name)
    missing = [n for n, (dtype, _) in meta.items()
               if n not in out and dtype != _DT_STRING]
    if missing:
        raise ValueError(f"{path}: no data for {missing}")
    return out


def checkpoint_present(path: str | None) -> bool:
    """A TF checkpoint at ``path``: a V2 pair (``path.index``) or a V1
    file."""
    return bool(path) and (os.path.exists(path + ".index")
                           or os.path.exists(path))


def load_tf_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a TF checkpoint by name (string tensors left
    out): V2 when ``path + ".index"`` exists, else V1 when ``path`` is a
    file. ``FileNotFoundError`` when neither exists."""
    if os.path.exists(path + ".index"):
        return _read_v2(path)
    if os.path.isfile(path):
        return _read_v1(path)
    raise FileNotFoundError(f"no TF checkpoint at {path} (neither "
                            f"{path}.index nor {path})")
