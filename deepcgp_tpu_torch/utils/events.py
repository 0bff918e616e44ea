"""TensorBoard event files, written and read with the standard library and
numpy alone (the card's machine has no tensorboardX, tensorboard or PIL).

An event file is a sequence of TFRecords, each

    uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)

(little-endian), whose data is one serialized ``Event`` protobuf.  The
messages are encoded by hand, field by field:

* ``Event``: wall_time (1, double), step (2, int64), file_version (3,
  string) or summary (5, ``Summary``);
* ``Summary``: repeated value (1, ``Value``): tag (1, string) and one of
  simple_value (2, float), image (4, ``Image``: height 1, width 2,
  colorspace 3, encoded_image_string 4) and histo (5, ``HistogramProto``:
  min 1, max 2, num 3, sum 4, sum_squares 5, packed bucket_limit 6 and
  bucket 7, all doubles).

The first record is the ``brain.Event:2`` file version, as tensorboardX
writes it, and every tag is cleaned as tensorboardX cleans it (each
character but a letter, a digit, '_', '-', '/' and '.' becomes '_', and
leading slashes go), so the JAX logger's 'model.layers[0].Z' is stored as
'model.layers_0_.Z' by both.  Histograms take tensorboardX's default
bucket limits (``bins='tensorflow'``: +-1e-12 growing by 1.1 up to 1e20,
and 0) and its support trimming; images take its float handling (values
in [0, 1] times 255, truncated to uint8, a grey channel repeated to RGB)
and are PNGs compressed with ``zlib``.  :func:`read_events` reads the records back,
checks every CRC and decodes what :class:`EventWriter` writes.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import time
import zlib

import numpy as np

FILE_VERSION = 'brain.Event:2'
_INVALID_TAG_CHARACTERS = re.compile(r'[^-/\w\.]')


def clean_tag(tag: str) -> str:
    """tensorboardX's ``_clean_tag``."""
    return _INVALID_TAG_CHARACTERS.sub('_', tag).lstrip('/')


# ------------------------------------------------------------- CRC32C

_CRC32C_POLY = 0x82F63B78   # Castagnoli, reflected


def _crc_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord around ``data``."""
    header = struct.pack('<Q', len(data))
    return (header + struct.pack('<I', masked_crc32c(header)) + data
            + struct.pack('<I', masked_crc32c(data)))


# ----------------------------------------------------- protobuf encoding


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1            # int64 two's complement, as protobuf does
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack('<d', float(value))


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack('<f', float(value))


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _packed_doubles(field: int, values) -> bytes:
    return _bytes_field(field, np.asarray(values, '<f8').tobytes())


def encode_event(wall_time: float, step: int = 0,
                 file_version: str | None = None,
                 summary: bytes | None = None) -> bytes:
    out = _double_field(1, wall_time)
    if step:
        out += _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _summary(tag: str, field: int, payload: bytes) -> bytes:
    return _bytes_field(1, _bytes_field(1, clean_tag(tag).encode()) + payload)


def scalar_summary(tag: str, value: float) -> bytes:
    return _summary(tag, 2, _float_field(2, value))


def _default_bins() -> list:
    """tensorboardX's default histogram bucket limits."""
    v, buckets, neg = 1e-12, [], []
    while v < 1e20:
        buckets.append(v)
        neg.append(-v)
        v *= 1.1
    return neg[::-1] + [0] + buckets


DEFAULT_BINS = _default_bins()


def histogram(values) -> dict:
    """tensorboardX's ``make_histogram`` over ``DEFAULT_BINS``: the
    buckets from the one left of the first non-empty bucket to the last
    non-empty one (an empty bucket prepended at the left edge), with
    min, max, num, sum and sum_squares of the values in float64."""
    values = np.asarray(values, dtype=float).reshape(-1)
    if values.size == 0:
        raise ValueError('histogram: no values')
    counts, limits = np.histogram(values, bins=DEFAULT_BINS)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side='right')
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return {'min': values.min(), 'max': values.max(), 'num': len(values),
            'sum': values.sum(), 'sum_squares': values.dot(values),
            'bucket_limit': limits.tolist(), 'bucket': counts.tolist()}


def histogram_summary(tag: str, values) -> bytes:
    h = histogram(values)
    payload = (_double_field(1, h['min']) + _double_field(2, h['max'])
               + _double_field(3, h['num']) + _double_field(4, h['sum'])
               + _double_field(5, h['sum_squares'])
               + _packed_doubles(6, h['bucket_limit'])
               + _packed_doubles(7, h['bucket']))
    return _summary(tag, 5, _bytes_field(5, payload))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(hwc: np.ndarray, text: dict | None = None) -> bytes:
    """uint8 [H, W, 3] -> an RGB PNG, every row unfiltered; each item of
    ``text`` ({keyword: value}, Latin-1) becomes a ``tEXt`` chunk."""
    H, W, C = hwc.shape
    if hwc.dtype != np.uint8 or C != 3:
        raise ValueError(f'encode_png: need uint8 [H, W, 3], got '
                         f'{hwc.dtype} {hwc.shape}')
    chunks = []
    for key, value in (text or {}).items():
        if not 1 <= len(key) <= 79 or '\0' in key + str(value):
            raise ValueError(f'encode_png: tEXt keyword {key!r}')
        chunks.append(_png_chunk(b'tEXt', key.encode('latin-1') + b'\0'
                                 + str(value).encode('latin-1')))
    raw = b''.join(b'\x00' + hwc[y].tobytes() for y in range(H))
    return (b'\x89PNG\r\n\x1a\n'
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', W, H, 8, 2, 0, 0, 0))
            + b''.join(chunks)
            + _png_chunk(b'IDAT', zlib.compress(raw))
            + _png_chunk(b'IEND', b''))


def image_pixels(chw: np.ndarray) -> np.ndarray:
    """A float [C, H, W] image in [0, 1] (C = 1 or 3) -> uint8 [H, W, 3], as
    tensorboardX's ``image`` turns it: x * 255 truncated, grey repeated."""
    hwc = np.asarray(chw).transpose(1, 2, 0)
    if hwc.shape[2] == 1:
        hwc = np.concatenate([hwc, hwc, hwc], 2)
    if hwc.dtype != np.uint8:
        hwc = (hwc * 255.0).astype(np.uint8)
    return hwc


def image_summary(tag: str, chw: np.ndarray) -> bytes:
    hwc = image_pixels(chw)
    H, W, C = hwc.shape
    payload = (_int_field(1, H) + _int_field(2, W) + _int_field(3, C)
               + _bytes_field(4, encode_png(hwc)))
    return _summary(tag, 4, _bytes_field(4, payload))


class EventWriter:
    """Appends events to ``<logdir>/events.out.tfevents.<time>.<host>``,
    the name tensorboardX gives its files; the first record is the file
    version.  Each ``add_*`` writes one event at once; ``flush`` pushes
    them to the file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, 'events.out.tfevents.' + str(time.time())[:10] + '.'
            + socket.gethostname())
        self._file = open(self.path, 'wb')
        self._write(encode_event(time.time(), file_version=FILE_VERSION))

    def _write(self, event: bytes) -> None:
        self._file.write(record(event))

    def add_summary(self, summary: bytes, step: int) -> None:
        self._write(encode_event(time.time(), int(step), summary=summary))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_summary(scalar_summary(tag, value), step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        self.add_summary(histogram_summary(tag, values), step)

    def add_image(self, tag: str, chw: np.ndarray, step: int) -> None:
        self.add_summary(image_summary(tag, chw), step)

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


# ------------------------------------------------------------- reading


def read_records(path: str):
    """The data of every TFRecord in the file; a CRC that does not match,
    or a record cut short, raises ValueError."""
    with open(path, 'rb') as f:
        buf = f.read()
    pos, out = 0, []
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError(f'{path}: record header cut at byte {pos}')
        header = buf[pos:pos + 8]
        (n,) = struct.unpack('<Q', header)
        (crc,) = struct.unpack('<I', buf[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f'{path}: length CRC mismatch at byte {pos}')
        data = buf[pos + 12:pos + 12 + n]
        if len(data) != n or pos + 16 + n > len(buf):
            raise ValueError(f'{path}: record cut at byte {pos}')
        (crc,) = struct.unpack('<I', buf[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(data):
            raise ValueError(f'{path}: data CRC mismatch at byte {pos}')
        out.append(data)
        pos += 16 + n
    return out


def _read_varint(buf: bytes, pos: int):
    n, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _fields(buf: bytes):
    """(field, wire type, value) of each field of one message: an int for
    varints, the raw bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f'protobuf wire type {wire} is not read here')
        yield field, wire, value


def _double(b: bytes) -> float:
    return struct.unpack('<d', b)[0]


def _decode_histogram(buf: bytes) -> dict:
    names = {1: 'min', 2: 'max', 3: 'num', 4: 'sum', 5: 'sum_squares'}
    h = {'bucket_limit': [], 'bucket': []}
    for field, wire, value in _fields(buf):
        if field in names:
            h[names[field]] = _double(value)
        elif field in (6, 7):
            key = 'bucket_limit' if field == 6 else 'bucket'
            if wire == 2:
                h[key] += np.frombuffer(value, '<f8').tolist()
            else:
                h[key].append(_double(value))
    return h


def _decode_image(buf: bytes) -> dict:
    img = {}
    for field, _, value in _fields(buf):
        if field in (1, 2, 3):
            img[{1: 'height', 2: 'width', 3: 'colorspace'}[field]] = value
        elif field == 4:
            img['png'] = value
    return img


def _decode_value(buf: bytes) -> dict:
    out = {}
    for field, _, value in _fields(buf):
        if field == 1:
            out['tag'] = value.decode()
        elif field == 2:
            out['simple_value'] = struct.unpack('<f', value)[0]
        elif field == 4:
            out['image'] = _decode_image(value)
        elif field == 5:
            out['histo'] = _decode_histogram(value)
    return out


def decode_event(data: bytes) -> dict:
    """{'wall_time', 'step', and 'file_version' or 'summary': [values]}."""
    event = {'wall_time': 0.0, 'step': 0}
    for field, _, value in _fields(data):
        if field == 1:
            event['wall_time'] = _double(value)
        elif field == 2:
            event['step'] = value - (1 << 64) if value >> 63 else value
        elif field == 3:
            event['file_version'] = value.decode()
        elif field == 5:
            event['summary'] = [_decode_value(v) for f, _, v in _fields(value)
                                if f == 1]
    return event


def read_events(path: str) -> list:
    """Every event of an event file, CRCs checked."""
    return [decode_event(r) for r in read_records(path)]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_chunks(data: bytes):
    """(kind, body) of every chunk of a PNG, CRCs checked."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError('not a PNG')
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack('>I', data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f'PNG chunk {kind!r}: CRC mismatch')
        yield kind, body
        pos += 12 + n


def png_text(data: bytes) -> dict:
    """{keyword: value} of a PNG's ``tEXt`` chunks."""
    out = {}
    for kind, body in _png_chunks(data):
        if kind == b'tEXt':
            key, _, value = body.partition(b'\0')
            out[key.decode('latin-1')] = value.decode('latin-1')
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit grey, RGB or RGBA PNG, not interlaced -> uint8 [H, W, C],
    every PNG row filter undone."""
    idat, hdr = b'', None
    for kind, body in _png_chunks(data):
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat += body
    W, H, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f'PNG depth {depth}, colour type {ctype}, '
                         f'interlace {interlace}: not read here')
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = W * channels
    rows = raw.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(H):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind > 4:
            raise ValueError(f'PNG row filter {kind}')
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                pred = {1: a, 3: (a + b) // 2}.get(int(kind))
                if pred is None:
                    pred = int(_paeth(a, b, c))
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(H, W, channels)
