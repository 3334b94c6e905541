"""Image decoding for the vision encoder, without PIL (which the card's
machine lacks): PNG through stdlib ``zlib``, and Pillow's default resize.

``decode_image(data, size)`` gives what the JAX encoder's
``Image.open(...).convert("RGB").resize((size, size))`` gives, byte for
byte, for the PNG images it reads:

* PNG: the signature, chunks with their CRCs checked, IHDR / PLTE / IDAT /
  IEND (other ancillary chunks are skipped, as Pillow's decode skips
  them), zlib through stdlib, and the five row filters (Sub and Up
  vectorised with numpy; Average and Paeth depend on the byte to their
  left and run along the row);
* colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6
  (RGBA) at bit depth 8, converted to RGB as ``convert("RGB")`` converts
  them: grey replicated, the palette looked up, alpha dropped;
* the resize is Pillow's ``resize`` default for RGB, BICUBIC (a = -0.5)
  as ``Resample.c`` computes it: the filter's support widened by the
  scale when downscaling, each output's coefficients computed in double
  and normalised, then rounded to 22-bit fixed point; a horizontal pass
  over the rows the vertical pass reads, then a vertical pass, each
  rounded and clipped to uint8. An image already at the size is returned
  as it is.

It refuses by name (``ValueError``) what PIL would read and it does not:
JPEG, GIF, BMP, WebP and TIFF, Adam7-interlaced PNGs and bit depths other
than 8; and bytes that are no image at all.

``encode_png`` writes an 8-bit PNG with a chosen filter type per row (the
tests and chip_smoke drive every filter of the decoder with it).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: leading bytes of the formats PIL reads and this decoder refuses
_OTHER_FORMATS = (
    (b"\xff\xd8\xff", "JPEG"),
    (b"GIF87a", "GIF"),
    (b"GIF89a", "GIF"),
    (b"BM", "BMP"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
)
#: channels per pixel by PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: Resample.c's fixed-point precision for 8-bit images
PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def image_format(data: bytes) -> str:
    """The container's name from its leading bytes ("PNG", "JPEG", ...)."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG file: no IEND chunk")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(min(bpp, len(cur))):     # a = c = 0: the predictor is b
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        if pa <= pb and pa <= pc:
            cur[i] = (cur[i] + a) & 0xFF
        elif pb <= pc:
            cur[i] = (cur[i] + b) & 0xFF
        else:
            cur[i] = (cur[i] + c) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(min(bpp, len(cur))):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The filtered scanlines → [height, stride] uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, 3] uint8, as PIL's ``convert("RGB")`` gives them."""
    header = None
    palette = None
    idat: list[bytes] = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[0] & 0x20 == 0:   # an unknown critical chunk
            raise ValueError(f"unsupported PNG chunk {kind.decode('latin-1')!r}")
    if header is None:
        raise ValueError("broken PNG file: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not read (8 only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG images are not read")
    if comp or filt:
        raise ValueError(f"unsupported PNG compression {comp} / filter method {filt}")
    if width == 0 or height == 0:
        raise ValueError("PNG image has no pixels")
    bpp = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"broken PNG image data: {exc}") from None
    px = _unfilter(raw, height, width * bpp, bpp).reshape(height, width, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resample.c's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for
    BICUBIC over the whole axis: (xmin [out], xmax [out], the 22-bit
    coefficients [out, ksize], zero past each output's xmax)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    xmaxs = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            if ww != 0.0:
                w /= ww
            kk[xx, x] = int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0 else \
                int(0.5 + w * (1 << PRECISION_BITS))
        xmins[xx], xmaxs[xx] = xmin, xmax
    return xmins, xmaxs, kk


def _pass(img: np.ndarray, in_size: int, xmins: np.ndarray, kk: np.ndarray,
          axis: int) -> np.ndarray:
    """One resampling pass along ``axis`` (1: horizontal, 0: vertical):
    each output sums its taps (a zero coefficient past its xmax), plus the
    rounding half, shifted and clipped to uint8."""
    acc = None
    for t in range(kk.shape[1]):
        idx = np.minimum(xmins + t, in_size - 1)
        k = kk[:, t][:, None, None] if axis == 0 else kk[:, t][None, :, None]
        term = np.take(img, idx, axis=axis).astype(np.int64) * k
        acc = term if acc is None else acc + term
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``Image.resize((width, height))`` of an RGB image
    ([H, W, 3] uint8; BICUBIC, no box, no reducing gap)."""
    in_h, in_w = img.shape[:2]
    if (in_w, in_h) == (width, height):
        return img.copy()
    xmin_h, _xmax_h, k_h = _coeffs(in_w, width)
    ymin_v, ymax_v, k_v = _coeffs(in_h, height)
    if width != in_w:
        # only the rows the vertical pass reads
        first, last = int(ymin_v[0]), int(ymin_v[-1] + ymax_v[-1])
        img = _pass(img[first:last], in_w, xmin_h, k_h, axis=1)
        ymin_v = ymin_v - first
    if height != in_h:
        img = _pass(img, img.shape[0], ymin_v, k_v, axis=0)
    return img


def decode_image(data: bytes, size: int) -> np.ndarray:
    """Image bytes → [size, size, 3] uint8, as the JAX encoder's
    ``Image.open(...).convert("RGB").resize((size, size))`` gives them."""
    fmt = image_format(bytes(data[:16]))
    if fmt != "PNG":
        if fmt == "unknown":
            raise ValueError("cannot identify image file (the port decodes PNG only)")
        raise ValueError(f"{fmt} images are not read (the port decodes PNG only)")
    return resize_bicubic(decode_png(bytes(data)), size, size)


def encode_png(px: np.ndarray, ctype: int = 2, filters: tuple[int, ...] = (0,),
               palette: np.ndarray | None = None) -> bytes:
    """An 8-bit PNG of ``px`` ([H, W, channels] or [H, W] uint8, colour type
    ``ctype``), row ``y`` filtered with ``filters[y % len(filters)]``."""
    h, w = px.shape[:2]
    bpp = _CHANNELS[ctype]
    rows = np.ascontiguousarray(px, np.uint8).reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    zero = np.zeros(bpp, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        a = np.concatenate([zero, cur[:-bpp]])
        c = np.concatenate([zero, prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - a
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (a + prev) // 2
        elif f == 4:
            pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
            enc = cur - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out.append(f)
        out += (enc % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes())
    return data + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")
