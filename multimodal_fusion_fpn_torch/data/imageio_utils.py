"""PNG read and write for the port's data pipeline, on ``zlib`` and
``struct`` alone (``multimodal_fusion_fpn_tpu/data/imageio_utils.py``
reads and writes through imageio, which the port does not depend on).

:func:`imread` gives what ``imageio.v2.imread`` gives for the PNGs the
pipeline meets: non-interlaced, bit depth 8 or 16, grey, grey + alpha, RGB
or RGBA, any of the five row filters.  8-bit images come back as uint8,
(H, W) for grey and (H, W, C) otherwise.  16-bit grey comes back as
uint16 (H, W); 16-bit colour as the high bytes in uint8, and 16-bit grey +
alpha as uint8 RGBA with the grey repeated, as imageio's reader converts
them.  Anything else (palette images, bit depths below 8, interlace)
raises ``ValueError``.  The dtype matters: the FAF source inverts the
uint8 array, which wraps modulo 256.

:func:`imsave` writes uint8 arrays: (H, W) as 8-bit grey, (H, W, 3) as
RGB, (H, W, 4) as RGBA.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        yield kind, body
        if kind == b"IEND":
            return


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed stream: (height, stride)
    uint8.  None, Sub and Up are vectorised; Average and Paeth walk the row
    byte by byte."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError("PNG data has the wrong length")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:     # Sub: a running sum in each of the bpp lanes
            cur = np.empty(stride, np.uint8)
            for lane in range(bpp):
                np.cumsum(line[lane::bpp], dtype=np.uint8, out=cur[lane::bpp])
        elif kind == 2:     # Up
            cur = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(),
                                                        bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def imread(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace})")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                     bpp)
    if depth == 8:
        arr = rows.reshape(height, width, channels)
    else:
        arr = rows.view(">u2").reshape(height, width, channels)
        if channels == 1:
            return arr[..., 0].astype(np.uint16)
        arr = (arr >> 8).astype(np.uint8)
        if channels == 2:   # grey + alpha -> RGBA
            arr = arr[..., [0, 0, 0, 1]]
    return arr[..., 0].copy() if channels == 1 else np.ascontiguousarray(arr)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(array: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 (H, W), (H, W, 3) or (H, W, 4) array, every
    row with the Up filter (the difference to the row above)."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise ValueError(f"imsave writes uint8 arrays, not {arr.dtype}")
    if arr.ndim == 2:
        colour, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[2] in (3, 4):
        colour, channels = (2 if arr.shape[2] == 3 else 6), arr.shape[2]
    else:
        raise ValueError(f"imsave: cannot write an array of shape "
                         f"{arr.shape}")
    height, width = arr.shape[:2]
    rows = arr.reshape(height, width * channels)
    body = np.empty((height, width * channels + 1), np.uint8)
    body[:, 0] = 2
    body[:, 1:] = rows
    body[1:, 1:] -= rows[:-1]    # uint8 arithmetic wraps modulo 256
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
            + _chunk(b"IEND", b""))


def imsave(path: str, array: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(array))
