"""EXIF orientation as ``cv2.imread`` applies it (the JAX ``read_rgb``).

``cv2.imread(path)`` turns a colour frame by the orientation tag (0x0112)
of its EXIF block, from a JPEG's APP1 ``Exif\\0\\0`` segments or a PNG's
``eXIf`` chunk. This module reads the tag the way OpenCV's ``ExifReader``
does, fault for fault, because a frame turned differently is a wrong
answer without an error:

- only IFD0 is read (a tag that only a later IFD holds is ignored); the
  byte order is ``II`` little-endian, anything else big-endian; the TIFF
  mark must be 42;
- each IFD0 entry is read in turn into a map where the first entry of a
  tag wins. Reading a known tag's value out of the block's bounds stops
  the block, keeping the entries read before it: the strings
  (ImageDescription, Make, Model, Software, DateTime, Copyright; an
  inline string is read at byte 8 of the block), the rationals (X/Y
  resolution one, WhitePoint two, YCbCrCoefficients three,
  PrimaryChromaticities and ReferenceBlackWhite six), and the SHORTs
  (Orientation, ResolutionUnit, YCbCrPositioning), read as a 16-bit
  value at byte 8 of the entry whatever its type and count;
- a JPEG's every ``Exif\\0\\0`` APP1 segment before the first scan feeds
  the same map, in file order; a PNG has one block, the payload of the
  first ``eXIf`` chunk libpng keeps (``io/png.py``);
- values 1-8 turn the frame (OpenCV's ``ExifTransform``); any other value
  leaves it as decoded.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List

import numpy as np

ORIENTATION = 0x0112
# tags whose value OpenCV reads, by the kind of read
_STRING_TAGS = frozenset((0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298))
_SHORT_TAGS = frozenset((ORIENTATION, 0x0128, 0x0213))
# rational tags -> the number of unsigned rationals read at the entry's offset
_RATIONAL_TAGS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x0211: 3, 0x013F: 6, 0x0214: 6}
_ENTRY = 12  # bytes of one IFD entry


class _OutOfBounds(Exception):
    pass


class _Block:
    """One TIFF block, read with OpenCV's bounds checks."""

    def __init__(self, data: bytes):
        self.data = data
        self.little = data[:2] == b"II"

    def u16(self, off: int) -> int:
        if off + 1 >= len(self.data):
            raise _OutOfBounds
        return struct.unpack_from("<H" if self.little else ">H", self.data, off)[0]

    def u32(self, off: int) -> int:
        if off + 3 >= len(self.data):
            raise _OutOfBounds
        return struct.unpack_from("<I" if self.little else ">I", self.data, off)[0]


def _read_entry(block: _Block, off: int):
    """(tag, value) of the IFD entry at ``off``; value None for a tag whose
    value OpenCV keeps but this module does not need."""
    tag = block.u16(off)
    if tag in _SHORT_TAGS:
        return tag, block.u16(off + 8)
    if tag in _STRING_TAGS:
        size = block.u32(off + 4)
        start = block.u32(off + 8) if size > 4 else 8
        if start > len(block.data) or start + size > len(block.data):
            raise _OutOfBounds
    elif tag in _RATIONAL_TAGS:
        at = block.u32(off + 8)
        for k in range(2 * _RATIONAL_TAGS[tag]):
            block.u32(at + 4 * k)
    return tag, None


def parse_into(tags: Dict[int, int], data: bytes) -> None:
    """Read one TIFF block's IFD0 into ``tags``: the first value of a tag
    wins, and a read out of bounds ends the block."""
    if not data:
        return
    block = _Block(data)
    try:
        if block.u16(2) != 42:
            return
        off = block.u32(4)
        count = block.u16(off)
        off += 2
        for _ in range(count):
            tag, value = _read_entry(block, off)
            tags.setdefault(tag, value)
            off += _ENTRY
    except _OutOfBounds:
        return


def orientation(blocks: Iterable[bytes]) -> int:
    """The orientation OpenCV reads from these TIFF blocks, in file order
    (1, no turn, when none holds the tag)."""
    tags: Dict[int, int] = {}
    for data in blocks:
        parse_into(tags, data)
    value = tags.get(ORIENTATION)
    return 1 if value is None else value


def jpeg_exif_blocks(data: bytes) -> List[bytes]:
    """The TIFF blocks of a JPEG file: each APP1 segment before the first
    scan that starts with ``Exif\\0\\0``, without those six bytes."""
    blocks = []
    i, n = 2, len(data)
    while True:
        while i < n and data[i] != 0xFF:
            i += 1
        while i < n and data[i] == 0xFF:
            i += 1
        if i + 3 > n:
            return blocks
        m = data[i]
        i += 1
        if m in (0xD9, 0xDA):  # EOI, SOS
            return blocks
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        length = (data[i] << 8) | data[i + 1]
        seg = data[i + 2:i + length]
        if m == 0xE1 and seg[:6] == b"Exif\x00\x00":
            blocks.append(seg[6:])
        i += length


def apply_orientation(img: np.ndarray, value: int) -> np.ndarray:
    """Turn an (H, W, ...) image as OpenCV's ``ExifTransform`` does for
    ``value``; values outside 1-8 leave it as it is."""
    if 5 <= value <= 8:
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(value, ())
    if flip:
        img = np.flip(img, axis=flip)
    return np.ascontiguousarray(img)
