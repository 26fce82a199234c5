"""A baseline JPEG writer in numpy (nf_tpu writes its report files through
PIL, which the card's machine does not have).

``encode`` writes JFIF baseline JPEG (SOF0, 8-bit): 1 component for a
grey image, 3 (Y, Cb, Cr at full resolution, 4:4:4) for an RGB one, the
ITU-T T.81 Annex K quantization tables scaled to ``quality`` as libjpeg
scales them, and the Annex K Huffman tables.  The DCT is one matrix
product over every 8x8 block; the run lengths, the Huffman codes and the
bit packing are vectorised over the whole image (no loop over blocks), so
a 600 x 600 panel encodes in well under a second on a CPU.  ``read_header``
checks a file's SOI, SOF0 and EOI markers and returns its frame size.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

# Annex K.1 quantization tables, in zigzag order (as a DQT segment holds them)
_Q_LUMA = bytes.fromhex(
    "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933"
    "383740485c4e404457453738506d51575f626768673e4d71797064785c656763")
_Q_CHROMA = bytes.fromhex("1112121815182f1a1a2f634238426363") + b"\x63" * 48

# Annex K.3 Huffman tables: (code counts per length 1..16, symbols)
_DC_LUMA = ("00010501010101010100000000000000", "000102030405060708090a0b")
_DC_CHROMA = ("00030101010101010101010000000000", "000102030405060708090a0b")
_AC_LUMA = (
    "0002010303020403050504040000017d",
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA = (
    "00020102040403040705040400010277",
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")


def _zigzag() -> np.ndarray:
    """The natural (row-major) index of each zigzag position."""
    order = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda p: (p[0] + p[1], p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([i * 8 + j for i, j in order])


ZIGZAG = _zigzag()


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, JPEG's forward DCT per axis."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2.0 / 8)
    c[0] /= np.sqrt(2.0)
    return c


_DCT = _dct_matrix()


def quant_table(base: bytes, quality: int) -> np.ndarray:
    """An Annex K table scaled to ``quality`` (libjpeg's rule), zigzag."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = (np.frombuffer(base, np.uint8).astype(np.int64) * scale + 50) // 100
    return np.clip(q, 1, 255)


def _huffman(spec) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """(code, length) per symbol 0..255, and the DHT payload."""
    bits = bytes.fromhex(spec[0])
    vals = bytes.fromhex(spec[1])
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[vals[k]], size[vals[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size, bits + vals


_TABLES = [_huffman(s) for s in (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA)]


def _bit_size(v: np.ndarray) -> np.ndarray:
    """The JPEG category of each value: the bit length of |v|."""
    a = np.abs(v)
    out = np.zeros(v.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _amplitude(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The appended bits of value v in category s (one's complement for
    v < 0)."""
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(n_blocks, 64) quantizable coefficients of one level-shifted plane,
    blocks in row-major order; the plane padded by edge replication."""
    h, w = plane.shape
    ph, pw = -h % 8, -w % 8
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    bh, bw = p.shape[0] // 8, p.shape[1] // 8
    b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    return (_DCT @ b @ _DCT.T).reshape(-1, 64)


def _ycbcr(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def _scan(coeffs: np.ndarray, comp: np.ndarray) -> bytes:
    """The entropy-coded segment of the blocks ``coeffs`` (n, 64) zigzag,
    quantized, in scan order, block i of component ``comp[i]`` (0 Y, else
    chroma), byte-stuffed."""
    n = coeffs.shape[0]
    chroma = comp > 0
    # DC: differences along each component's own blocks
    dc = coeffs[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    s = _bit_size(diff)
    dc_code = np.where(chroma, _TABLES[2][0][s], _TABLES[0][0][s])
    dc_len = np.where(chroma, _TABLES[2][1][s], _TABLES[0][1][s])
    keys = [np.arange(n) * 1024]
    vals = [(dc_code << s) | _amplitude(diff, s)]
    lens = [dc_len + s]

    # AC: each nonzero coefficient after its zero run (16 zeros a ZRL)
    blk, pos = np.nonzero(coeffs[:, 1:])
    pos = pos + 1
    v = coeffs[blk, pos]
    first = np.ones(blk.shape, bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    zrl, run = run // 16, run % 16
    s = _bit_size(v)
    sym = (run << 4) | s
    ac_code = np.where(chroma[blk], _TABLES[3][0][sym], _TABLES[1][0][sym])
    ac_len = np.where(chroma[blk], _TABLES[3][1][sym], _TABLES[1][1][sym])
    keys.append(blk * 1024 + pos * 4 + 3)
    vals.append((ac_code << s) | _amplitude(v, s))
    lens.append(ac_len + s)
    if zrl.any():
        rep = np.repeat(np.arange(blk.size), zrl)
        j = np.arange(rep.size) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        zc = chroma[blk[rep]]
        keys.append(blk[rep] * 1024 + pos[rep] * 4 + j)
        vals.append(np.where(zc, _TABLES[3][0][0xF0], _TABLES[1][0][0xF0]))
        lens.append(np.where(zc, _TABLES[3][1][0xF0], _TABLES[1][1][0xF0]))
    # EOB where a block's last coefficient is zero
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 1024 + 1000)
    vals.append(np.where(chroma[eob], _TABLES[3][0][0], _TABLES[1][0][0]))
    lens.append(np.where(chroma[eob], _TABLES[3][1][0], _TABLES[1][1][0]))

    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    # each code's bits, most significant first, then the stream packed
    shift = ln[:, None] - 1 - np.arange(32)[None, :]
    bits = ((val[:, None] >> np.maximum(shift, 0)) & 1).astype(np.uint8)
    stream = bits[shift >= 0]
    pad = -stream.size % 8
    packed = np.packbits(np.concatenate([stream, np.ones(pad, np.uint8)]))
    ff = np.nonzero(packed == 0xFF)[0]
    return np.insert(packed, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def encode(image: np.ndarray, quality: int = 90) -> bytes:
    """JPEG bytes of an (H, W) or (H, W, 1 | 3) uint8 image."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise TypeError(f"encode takes uint8 pixels, not {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        planes = a[..., None].astype(np.float64)
    elif a.ndim == 3 and a.shape[-1] == 3:
        planes = _ycbcr(a)
    else:
        raise ValueError(f"encode takes (H, W), (H, W, 1) or (H, W, 3), not {a.shape}")
    h, w, nc = planes.shape
    qs = [quant_table(_Q_LUMA, quality), quant_table(_Q_CHROMA, quality)]
    per = []
    for c in range(nc):
        coeffs = _blocks(planes[..., c] - 128.0)[:, ZIGZAG]
        per.append(np.round(coeffs / qs[min(c, 1)]).astype(np.int64))
    nb = per[0].shape[0]
    # interleaved scan: block i of each component in turn (4:4:4)
    coeffs = np.stack(per, axis=1).reshape(nb * nc, 64)
    comp = np.tile(np.arange(nc), nb)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + b"\x00\x00")]
    out.append(_segment(0xDB, b"".join(bytes([i]) + q.astype(np.uint8).tobytes()
                                       for i, q in enumerate(qs[:1 if nc == 1 else 2]))))
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c + 1, 0x11, min(c, 1)]) for c in range(nc))
    out.append(_segment(0xC0, sof))
    dht = []
    for k, (_, _, payload) in enumerate(_TABLES[:2 if nc == 1 else 4]):
        tc, th = k % 2, k // 2
        dht.append(bytes([(tc << 4) | th]) + payload)
    out.append(_segment(0xC4, b"".join(dht)))
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0x00 if c == 0 else 0x11])
                                 for c in range(nc)) + bytes([0, 63, 0])
    out.append(_segment(0xDA, sos))
    out.append(_scan(coeffs, comp))
    out.append(b"\xff\xd9")
    return b"".join(out)


def read_header(data: bytes) -> Tuple[int, int, int]:
    """(height, width, components) of baseline JPEG bytes; raises
    ``ValueError`` without SOI first, an SOF0 frame before the scan, or
    EOI last."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI marker")
    if data[-2:] != b"\xff\xd9":
        raise ValueError("no EOI marker")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"no marker at byte {i}")
        marker = data[i + 1]
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if marker == 0xC0:
            _, h, w, nc = struct.unpack(">BHHB", data[i + 4:i + 10])
            return h, w, nc
        if marker == 0xDA:
            break
        i += 2 + length
    raise ValueError("no SOF0 frame before the scan")
