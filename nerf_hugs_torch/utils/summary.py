"""TensorBoard event files without TensorFlow.

SummaryWriter has the calls of flax.metrics.tensorboard.SummaryWriter that
the train driver makes (scalar, histogram, image, flush, close) and writes
the records flax's writer writes (TF2 summaries), so that a TensorBoard
reader gets the same tags, steps and tensors from either file:
- each record is TFRecord-framed: the payload's length (uint64), the
  masked CRC-32C of those 8 bytes, the payload, the masked CRC-32C of the
  payload;
- the first record is an Event with file_version "brain.Event:2", the
  file is named events.out.tfevents.{time}.{host}.{pid}.{n}.v2;
- scalars: a float32 rank-0 tensor, plugin `scalars`;
- histograms: a [k, 3] float64 tensor of (left, right, count) with
  tf.summary.histogram's 30 buckets and edge rules, plugin `histograms`;
- images: a string tensor [width, height, png, ...] of at most
  max_outputs PNGs, plugin `images`; floats become uint8 as
  tf.image.convert_image_dtype(saturate=True) makes them (x * 255.5 in
  the image's dtype, clipped to [0, 255], truncated; NaN gives 0).
The protobuf messages (Event, Summary.Value, SummaryMetadata, TensorProto,
TensorShapeProto) are encoded by hand, field for field as flax's writer
emits them; PNGs are built with zlib and struct.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
import zlib

import numpy as np

_CRC32C_POLY = 0x82F63B78        # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8
_U32 = 0xFFFFFFFF


def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_CRC32C_POLY),
                         table >> 1).astype(np.uint32)
    return table


_TABLE = _crc_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _zero_bytes_tables(n: int) -> list:
    """The register after n zero bytes is linear in the register before:
    four 256-entry tables, one per byte of the register."""
    regs = (np.arange(256, dtype=np.uint32)[None, :]
            << (8 * np.arange(4, dtype=np.uint32))[:, None])
    for _ in range(n):
        regs = _TABLE[regs & 0xFF] ^ (regs >> 8)
    return [[int(v) for v in row] for row in regs]


def crc32c(data: bytes) -> int:
    """CRC-32C of `data`. Long inputs are cut into lanes of equal length
    whose registers advance together in numpy, then are joined in order
    through the zero-byte tables of one lane's length."""
    crc = _U32
    n = len(data)
    lane = int(np.sqrt(n))
    if lane >= 64:
        lanes = n // lane
        body = np.frombuffer(data, np.uint8, lanes * lane).reshape(lanes,
                                                                    lane)
        regs = np.zeros(lanes, np.uint32)
        for j in range(lane):
            regs = _TABLE[(regs ^ body[:, j]) & 0xFF] ^ (regs >> 8)
        t0, t1, t2, t3 = _zero_bytes_tables(lane)
        for reg in regs.tolist():
            crc = (t0[crc & 0xFF] ^ t1[(crc >> 8) & 0xFF]
                   ^ t2[(crc >> 16) & 0xFF] ^ t3[crc >> 24] ^ reg)
        data = data[lanes * lane:]
    for b in data:
        crc = _TABLE_LIST[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ _U32


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & _U32) + _MASK_DELTA) & _U32


def tfrecord(payload: bytes) -> bytes:
    """One TFRecord frame around `payload`."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# Protobuf wire format: varints (wire type 0), 64-bit (1) and
# length-delimited (2) fields.
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _varint_field(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _double_field(number: int, value: float) -> bytes:
    return _varint(number << 3 | 1) + struct.pack("<d", value)


# TensorProto.dtype values (tensorflow/core/framework/types.proto).
_DT_FLOAT, _DT_DOUBLE, _DT_STRING = 1, 2, 7


def _tensor(dtype: int, shape, content: bytes = b"",
            strings=()) -> bytes:
    """TensorProto: dtype (1), tensor_shape (2: a TensorShapeProto of dim
    (2) messages with size (1)), tensor_content (4), string_val (8)."""
    dims = b"".join(_field(2, _varint_field(1, d) if d else b"")
                    for d in shape)
    out = _varint_field(1, dtype) + _field(2, dims)
    if content:
        out += _field(4, content)
    return out + b"".join(_field(8, s) for s in strings)


def _event(step: int, wall_time: float, tag: str, tensor: bytes,
           plugin: str) -> bytes:
    """Event: wall_time (1), step (2, left out at 0 as proto3 does),
    summary (5) of one Summary.Value: tag (1), tensor (8), metadata (9) =
    SummaryMetadata with plugin_data (1) = {plugin_name (1)}."""
    metadata = _field(1, _field(1, plugin.encode()))
    value = (_field(1, tag.encode()) + _field(8, tensor)
             + _field(9, metadata))
    out = _double_field(1, wall_time)
    if step:
        out += _varint_field(2, step)
    return out + _field(5, _field(1, value))


_BUCKETS = 30                    # tf.summary.histogram's default


def histogram_buckets(values) -> np.ndarray:
    """[30, 3] (left, right, count), float64, by tf.summary.histogram's
    rules: equal widths from min to max (the last edge max itself, the
    largest value in the last bucket); one distinct value puts every count
    in the last bucket, all edges at it; no values give zeros."""
    data = np.asarray(values, np.float64).reshape(-1)
    if data.size == 0:
        return np.zeros((_BUCKETS, 3))
    lo, hi = data.min(), data.max()
    if hi - lo == 0:
        counts = np.zeros(_BUCKETS)
        counts[-1] = data.size
        edges = np.full(_BUCKETS, hi)
        return np.stack([edges, edges, counts], axis=1)
    width = (hi - lo) / _BUCKETS
    index = np.minimum(np.floor((data - lo) / width).astype(np.int64),
                       _BUCKETS - 1)
    counts = np.bincount(index, minlength=_BUCKETS).astype(np.float64)
    edges = np.concatenate([[lo], lo + np.arange(1, _BUCKETS) * width,
                            [hi]])
    return np.stack([edges[:-1], edges[1:], counts], axis=1)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """tf.image.convert_image_dtype(image, uint8, saturate=True)."""
    if image.dtype == np.uint8:
        return image
    if not np.issubdtype(image.dtype, np.floating):
        raise TypeError(f"images are uint8 or float, got {image.dtype}")
    with np.errstate(invalid="ignore"):
        scaled = np.clip(image * image.dtype.type(255.5), 0, 255)
    return np.nan_to_num(scaled, nan=0.0).astype(np.uint8)


_PNG_COLOR_TYPES = {3: 2, 4: 6}     # RGB, RGBA


def encode_png(image: np.ndarray) -> bytes:
    """[H, W, 3 or 4] uint8 -> PNG bytes (8 bits, no interlace)."""
    height, width, channels = image.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           image.reshape(height, width * channels)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8,
                         _PNG_COLOR_TYPES[channels], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


_WRITERS = itertools.count()


class SummaryWriter:
    """Writes TensorBoard summaries into `log_dir`, flushing after every
    call as flax's writer does by default."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        name = (f"events.out.tfevents.{int(now):010d}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_WRITERS)}.v2")
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        version = (_double_field(1, float(int(now)))
                   + _field(3, b"brain.Event:2")
                   + _field(10, _field(
                       1, b"tensorflow.core.util.events_writer")))
        self._write(version)

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))
        self._file.flush()

    def _summary(self, tag: str, tensor: bytes, step: int,
                 plugin: str) -> None:
        self._write(_event(int(step), time.time(), tag, tensor, plugin))

    def scalar(self, tag: str, value, step: int) -> None:
        content = np.float32(float(np.asarray(value))).tobytes()
        self._summary(tag, _tensor(_DT_FLOAT, (), content), step, "scalars")

    def histogram(self, tag: str, values, step: int) -> None:
        buckets = histogram_buckets(values)
        self._summary(tag, _tensor(_DT_DOUBLE, buckets.shape,
                                   buckets.astype("<f8").tobytes()),
                      step, "histograms")

    def image(self, tag: str, image, step: int, max_outputs: int = 3) -> None:
        """image: [H, W], [H, W, 1], [H, W, 3], [K, H, W], [K, H, W, C],
        uint8 or float in [0, 1] (flax's reshaping: [H, W] and one channel
        become grey RGB)."""
        image = np.asarray(image)
        if image.ndim == 2:
            image = image[None, :, :, None]
        elif image.ndim == 3:
            image = (image[None] if image.shape[-1] in (1, 3)
                     else image[..., None])
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        images = to_uint8(image)
        strings = [str(images.shape[2]).encode(),
                   str(images.shape[1]).encode()]
        strings += [encode_png(im) for im in images[:max_outputs]]
        self._summary(tag, _tensor(_DT_STRING, (len(strings),),
                                   strings=strings), step, "images")

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
