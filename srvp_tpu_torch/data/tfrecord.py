"""TFRecord files and tf.train.Example records in pure Python, without
TensorFlow (the counterpart of preprocessing/bair/tfrecord_reader.py): BAIR's
softmotion30_44k download is a set of such files (data/convert.py).

The two formats:

  * TFRecord framing: per record, the payload's length as a little-endian
    uint64, the masked CRC-32C of those 8 bytes, the payload, and the masked
    CRC-32C of the payload. The reader does not check the CRCs, as the JAX
    package's reader does not; the writer computes them.
  * tf.train.Example in the protobuf wire format:
      Example{1: Features{1: repeated map entry {1: key, 2: Feature}}},
      Feature{1: BytesList, 2: FloatList, 3: Int64List}, each list a
      repeated field 1 (packed or not).

`parse_example` gives {key: list of bytes, floats or ints}; int64 values are
signed. `encode_example` and `write_tfrecord` write synthetic downloads (the
floats and ints packed, as TensorFlow writes them).
"""

import struct


def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf, start, end):
    """Yields (field number, wire type, value) over a protobuf message:
    an int (varint), bytes (fixed 64 or 32 bits) or the (start, end) span
    of a length-delimited field."""
    pos = start
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = (pos, pos + n)
            pos += n
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _signed(v):
    """An int64 varint, two's complement in 64 bits, as a signed int."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_bytes_list(buf, span):
    return [buf[s:e] for f, _, (s, e) in _iter_fields(buf, *span) if f == 1]


def _parse_float_list(buf, span):
    out = []
    for f, w, val in _iter_fields(buf, *span):
        if f != 1:
            continue
        if w == 2:
            s, e = val
            out.extend(struct.unpack(f"<{(e - s) // 4}f", buf[s:e]))
        else:
            out.append(struct.unpack("<f", val)[0])
    return out


def _parse_int64_list(buf, span):
    out = []
    for f, w, val in _iter_fields(buf, *span):
        if f != 1:
            continue
        if w == 2:
            pos, end = val
            while pos < end:
                v, pos = _read_varint(buf, pos)
                out.append(_signed(v))
        else:
            out.append(_signed(val))
    return out


_LISTS = {1: _parse_bytes_list, 2: _parse_float_list, 3: _parse_int64_list}


def parse_example(buf):
    """A serialized tf.train.Example -> {key: list of bytes, floats or
    ints}."""
    features = {}
    for f, _, span in _iter_fields(buf, 0, len(buf)):
        if f != 1:
            continue
        for f2, _, entry in _iter_fields(buf, *span):
            if f2 != 1:
                continue
            key = value = None
            for f3, _, v in _iter_fields(buf, *entry):
                if f3 == 1:
                    key = buf[v[0]:v[1]].decode("utf-8")
                elif f3 == 2:
                    value = v
            if key is None or value is None:
                continue
            parsed = None
            for f4, _, v in _iter_fields(buf, *value):
                if f4 in _LISTS:
                    parsed = _LISTS[f4](buf, v)
            features[key] = parsed
    return features


def tfrecord_iterator(path):
    """Yields the payloads of a TFRecord file's records, a truncated last
    record left out."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)
            payload = f.read(length)
            if len(payload) < length:
                return
            f.read(4)
            yield payload


def _varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while n > 0x7F:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field(number, payload):
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features):
    """{key: list of bytes, floats or ints} -> a serialized
    tf.train.Example; a list's type is that of its first element."""
    entries = []
    for key, values in features.items():
        if isinstance(values[0], bytes):
            feature = _field(1, b"".join(_field(1, v) for v in values))
        elif isinstance(values[0], float):
            feature = _field(2, _field(1, struct.pack(f"<{len(values)}f",
                                                      *values)))
        else:
            feature = _field(3, _field(1, b"".join(_varint(v)
                                                   for v in values)))
        entries.append(_field(1, _field(1, key.encode()) + _field(2, feature)))
    return _field(1, b"".join(entries))


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of bytes."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data):
    """TFRecord's masked CRC: the CRC-32C rotated right by 15 bits plus a
    constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def write_tfrecord(path, payloads):
    """Writes the payloads as the records of a TFRecord file."""
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header + struct.pack("<I", masked_crc32c(header)) + p
                    + struct.pack("<I", masked_crc32c(p)))
