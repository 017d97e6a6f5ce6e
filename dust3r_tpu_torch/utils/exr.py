"""A minimal OpenEXR scanline codec (numpy and zlib).

Counterpart of `dust3r_tpu/utils/exr.py`. The training datasets store
their depth maps as .exr (BlendedMVS, MegaDepth, StaticThings3D, Waymo,
Habitat); the port reads them with `read_exr` (`utils/image.imread_cv2`)
and writes them with `write_exr`. The port carries no cv2, so
`imwrite_exr` is `write_exr`: the path JAX's `imwrite_exr` takes where
cv2 has no OpenEXR writer. Its values equal what such a cv2 writes, its
bytes do not.

Supported subset (what the reference pipeline produces):
  * single-part scanline images, increasing line order
  * pixel types HALF and FLOAT
  * compression NONE, ZIPS (1 line a block) and ZIP (16 lines a block)
  * 1-channel (Y) or 3-channel (B/G/R) images

Format per the OpenEXR 2.0 spec: magic 0x01312f76, version, attribute
list, scanline offset table, then per block [y:int32][size:int32][data].
ZIP data is zlib over a byte de-interleave + delta predictor (ImfZip).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_HALF, _PIXEL_FLOAT = 1, 2
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP = 0, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}
_DTYPES = {_PIXEL_HALF: np.dtype("<f2"), _PIXEL_FLOAT: np.dtype("<f4")}
_COMPRESSIONS = {"none": _COMP_NONE, "zips": _COMP_ZIPS, "zip": _COMP_ZIP}


def _predictor_encode(raw):
    """ImfZip's compress transform: byte de-interleave, then delta + 128."""
    a = np.frombuffer(raw, np.uint8)
    t = np.concatenate([a[0::2], a[1::2]]).astype(np.int16)
    t[1:] = t[1:] - t[:-1] + 128  # the right side is read before it is written
    return t.astype(np.uint8).tobytes()


def _predictor_decode(buf):
    """The inverse: t[i] = t[i-1] + d[i] - 128 (a cumulative sum mod 256),
    then re-interleave."""
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    d[1:] -= 128
    t = np.cumsum(d).astype(np.uint8)
    half = (len(t) + 1) // 2
    out = np.empty_like(t)
    out[0::2], out[1::2] = t[:half], t[half:]
    return out.tobytes()


def _read_cstr(buf, pos):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(data):
    """chlist attribute -> [(name, pixel type)] in file order."""
    chans, pos = [], 0
    while data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        ptype, = struct.unpack_from("<i", data, pos)
        pos += 16  # pixel type, pLinear + reserved, xSampling, ySampling
        chans.append((name, ptype))
    return chans


def read_exr(path_or_bytes):
    """A (subset) EXR file or its bytes -> float32 (H, W) or (H, W, 3) RGB."""
    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200 or version & 0x1000:
        raise NotImplementedError("tiled/multipart EXR not supported")

    pos, attrs = 8, {}
    while buf[pos] != 0:
        name, pos = _read_cstr(buf, pos)
        _, pos = _read_cstr(buf, pos)  # the attribute's type
        size, = struct.unpack_from("<i", buf, pos)
        attrs[name] = buf[pos + 4:pos + 4 + size]
        pos += 4 + size
    pos += 1  # the header's terminator

    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    comp = attrs["compression"][0]
    if comp not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {comp} not supported "
                                  "(only NONE/ZIP/ZIPS)")
    chans = _parse_channels(attrs["channels"])
    dtypes = [_DTYPES[t] for _, t in chans]
    row_bytes = sum(d.itemsize for d in dtypes) * W
    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (H + lpb - 1) // lpb
    pos += 8 * n_blocks  # the offset table: the blocks follow in order

    planes = {name: np.empty((H, W), np.float32) for name, _ in chans}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, pos)
        data = buf[pos + 8:pos + 8 + size]
        pos += 8 + size
        y0 = y - ymin
        n_lines = min(lpb, H - y0)
        if comp != _COMP_NONE and size < row_bytes * n_lines:
            data = _predictor_decode(zlib.decompress(data))
        for li in range(n_lines):
            off = li * row_bytes
            for (name, _), dt in zip(chans, dtypes):
                n = W * dt.itemsize
                planes[name][y0 + li] = np.frombuffer(data[off:off + n], dt)
                off += n

    names = [n for n, _ in chans]
    if len(names) == 1:
        return planes[names[0]]
    if sorted(names) == ["B", "G", "R"]:
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    return np.stack([planes[n] for n in sorted(names)], axis=-1)


def _attr(name, typ, data):
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(names, ptype):
    out = b"".join(n.encode() + b"\0" + struct.pack("<i", ptype) + b"\0\0\0\0"
                   + struct.pack("<ii", 1, 1) for n in sorted(names))  # alphabetical
    return out + b"\0"


def write_exr(path, img, half=False, compression="zip"):
    """Write a float (H, W) or (H, W, 3) RGB array as a scanline EXR:
    HALF or FLOAT pixels, compression "none", "zips" or "zip"."""
    img = np.asarray(img)
    if img.ndim == 2:
        planes = {"Y": img}
    elif img.ndim == 3 and img.shape[2] == 3:
        planes = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    H, W = img.shape[:2]
    ptype = _PIXEL_HALF if half else _PIXEL_FLOAT
    dt = _DTYPES[ptype]
    comp = _COMPRESSIONS[compression]
    lpb = _LINES_PER_BLOCK[comp]
    names = sorted(planes)

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join([
        _attr("channels", "chlist", _chlist(names, ptype)),
        _attr("compression", "compression", bytes([comp])),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", b"\0"),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0"])

    # each line holds its channels one after the other, alphabetically
    rows = np.stack([planes[n] for n in names], axis=1).astype(dt)  # (H, C, W)
    blocks = []
    for y0 in range(0, H, lpb):
        raw = rows[y0:y0 + lpb].tobytes()
        data = raw
        if comp != _COMP_NONE:
            packed = zlib.compress(_predictor_encode(raw))
            if len(packed) < len(raw):  # the spec stores raw where zip does not help
                data = packed
        blocks.append((y0, data))

    offsets, pos = [], 8 + len(header) + 8 * len(blocks)
    for _, data in blocks:
        offsets.append(pos)
        pos += 8 + len(data)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def imwrite_exr(path, img):
    """Write a float image as .exr: `write_exr` at its defaults (FLOAT, ZIP),
    what JAX's `imwrite_exr` writes where cv2 has no OpenEXR codec."""
    write_exr(path, img)
