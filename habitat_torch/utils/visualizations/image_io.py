"""PNG and animated-GIF writers in numpy, ``zlib`` and ``struct`` only (the
JAX package writes through PIL and imageio, which the port does not use).

``encode_png(image)``: 8-bit RGB, lossless. Every row gets filter type 0
(none) and the rows are deflated with ``zlib``; the chunks carry their CRC32
(``sims/loaders.py::decode_png`` is the reading side).

``encode_gif(frames, fps)``: a GIF89a that loops forever. Each frame has a
graphics-control block whose delay is ``round(100 / fps)`` centiseconds and
its own local colour table of at most 256 colours:

- ``quantize`` builds that table. A frame with at most 256 distinct colours
  keeps them exactly. Otherwise a median cut runs over the frame's distinct
  colours weighted by their pixel counts: the box with the largest weighted
  squared deviation is split at the weighted median of its widest channel
  (largest weighted variance) until there are 256 boxes; each box's colour
  is its weighted mean, and every pixel takes the nearest of those colours
  (squared RGB distance). No dithering.
- The indices are LZW-coded with GIF's variable code width: a clear code
  first, the width growing when a new table entry needs another bit, and a
  clear code when the 12-bit table is full. Codes are packed least
  significant bit first into sub-blocks of at most 255 bytes.
"""

from __future__ import annotations

import heapq
import struct
import zlib
from typing import Iterable, List, Tuple

import numpy as np

MAX_COLORS = 256


def _rgb_u8(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"expected uint8 pixels, got {image.dtype}")
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    if image.ndim != 3 or image.shape[-1] not in (1, 3, 4):
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    return np.ascontiguousarray(image[..., :3])


# -- PNG -----------------------------------------------------------------------
def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 (or (H, W) / (H, W, 1) gray) -> PNG bytes."""
    rgb = _rgb_u8(image)
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(rows.tobytes())),
        _png_chunk(b"IEND", b""),
    ])


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


# -- palette -------------------------------------------------------------------
def _box_cost(colors: np.ndarray, weights: np.ndarray) -> Tuple[float, int]:
    """(weighted squared deviation of the box, its channel of largest
    weighted variance)."""
    w = weights / weights.sum()
    mean = w @ colors
    var = w @ (colors - mean) ** 2
    return float(var.sum() * weights.sum()), int(np.argmax(var))


def _nearest(colors: np.ndarray, palette: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """Index of the nearest palette entry of each colour (squared RGB
    distance, the lower index on a tie)."""
    c = colors.astype(np.int32)
    p = palette.astype(np.int32)
    out = np.empty(len(c), np.int64)
    for s in range(0, len(c), chunk):
        d = ((c[s:s + chunk, None, :] - p[None]) ** 2).sum(-1)
        out[s:s + chunk] = d.argmin(-1)
    return out


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (palette (K, 3) uint8 with K <= MAX_COLORS,
    indices (H, W) uint8)."""
    rgb = _rgb_u8(frame)
    h, w = rgb.shape[:2]
    px = rgb.reshape(-1, 3).astype(np.int32)
    packed = (px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=-1).astype(np.float64)
    if len(uniq) <= MAX_COLORS:
        return colors.astype(np.uint8), inverse.reshape(h, w).astype(np.uint8)

    weights = counts.astype(np.float64)
    heap: List[Tuple[float, int, np.ndarray, int]] = []
    serial = 0

    def push(members: np.ndarray) -> None:
        nonlocal serial
        cost, channel = _box_cost(colors[members], weights[members])
        heapq.heappush(heap, (-cost, serial, members, channel))
        serial += 1

    push(np.arange(len(uniq)))
    done: List[np.ndarray] = []
    while heap and len(heap) + len(done) < MAX_COLORS:
        neg_cost, _, members, channel = heapq.heappop(heap)
        if neg_cost == 0.0 or len(members) < 2:
            done.append(members)
            continue
        order = members[np.argsort(colors[members, channel], kind="stable")]
        cum = np.cumsum(weights[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        cut = min(max(cut, 1), len(order) - 1)
        push(order[:cut])
        push(order[cut:])
    boxes = done + [b for _, _, b, _ in heap]
    palette = np.stack([
        np.round(weights[b] @ colors[b] / weights[b].sum()) for b in boxes
    ]).clip(0, 255).astype(np.uint8)
    index = _nearest(colors.astype(np.uint8), palette)
    return palette, index[inverse].reshape(h, w).astype(np.uint8)


# -- LZW -----------------------------------------------------------------------
def _lzw_codes(indices: bytes, min_size: int) -> Tuple[List[int], List[int]]:
    """GIF LZW of ``indices``: the codes and the bit width of each."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    codes, widths = [clear], [min_size + 1]
    table: dict = {}
    size, last = min_size + 1, eoi  # last assigned code
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(size)
        last += 1
        table[key] = last
        if last >= (1 << size) and size < 12:
            size += 1
        if last == 4095:  # table full: start over
            codes.append(clear)
            widths.append(size)
            table.clear()
            size, last = min_size + 1, eoi
        prefix = k
    codes += [prefix, eoi]
    widths += [size, size]
    return codes, widths


def _pack_bits(codes: List[int], widths: List[int]) -> bytes:
    """Codes packed least significant bit first."""
    c = np.asarray(codes, np.int64)
    wd = np.asarray(widths, np.int64)
    bits = (c[:, None] >> np.arange(12)) & 1
    keep = np.arange(12)[None, :] < wd[:, None]
    return np.packbits(bits[keep].astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for s in range(0, len(data), 255):
        piece = data[s:s + 255]
        out.append(len(piece))
        out += piece
    out.append(0)
    return bytes(out)


def gif_delay_cs(fps: float) -> int:
    """The frame delay in centiseconds that ``fps`` asks."""
    return int(round(100.0 / fps))


def encode_gif(frames: Iterable[np.ndarray], fps: float = 10) -> bytes:
    """Equal-size (H, W, 3) uint8 frames -> animated GIF bytes."""
    frames = [_rgb_u8(f) for f in frames]
    if not frames:
        raise ValueError("no frames to encode")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("every frame must have the first frame's size")
    if h > 65535 or w > 65535:
        raise ValueError(f"frame {h}x{w} is larger than a GIF can hold")
    delay = gif_delay_cs(fps)
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0, 0, 0)  # no global colour table
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"  # loop forever
    for frame in frames:
        palette, index = quantize(frame)
        bits = max(1, int(np.ceil(np.log2(len(palette)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[: len(palette)] = palette
        out += b"\x21\xf9\x04" + struct.pack("<BHBB", 1 << 2, delay, 0, 0)  # do not dispose
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1))
        out += table.tobytes()
        min_size = max(2, bits)
        out.append(min_size)
        out += _sub_blocks(_pack_bits(*_lzw_codes(index.tobytes(), min_size)))
    out.append(0x3B)
    return bytes(out)


def write_gif(path: str, frames: Iterable[np.ndarray], fps: float = 10) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, fps))
