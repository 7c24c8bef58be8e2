"""PDF: a one-page file written as Pillow 12.1.0's ``save`` writes it
(``PdfImagePlugin._save`` through ``PdfParser``).

The header and Pillow's comment, then the objects in file order: 4 the
Catalog, 5 the Pages, 1 the image XObject, 2 the Page, 3 its contents
stream, 6 the Info dictionary; then the cross-reference table (its first
entry ``0000000000 65536 f``), the trailer and ``startxref``. The page's
MediaBox is the image's size in points at 72 dpi. The image stream is the
file Pillow's writer for the mode makes: L and RGB through the JPEG
encoder (``jpeg.encode_jpeg``, ``DCTDecode``), RGBA through the JPEG 2000
one in the JP2 container (``jpeg2000.encode_jpeg2000``, ``JPXDecode``
with ``/SMaskInData 1``). The Info dictionary holds ``/Title``, the
file's base name without its extension (a byte-order mark then UTF-16BE,
with ``\\``, ``(`` and ``)`` escaped as ``PdfParser.pdf_repr`` escapes
bytes), and ``/CreationDate`` and ``/ModDate``, each ``time.gmtime()`` at
the save.

I;16 fails as in Pillow ("cannot save mode I;16"), after Pillow has
written the file's first objects: the error carries them
(``PdfModeError.partial``), which is what Pillow leaves in a file that
was there before.
"""

from __future__ import annotations

import codecs
import os
import time

import numpy as np

from .jpeg import encode_jpeg
from .jpeg2000 import encode_jpeg2000


class PdfModeError(ValueError):
    """A mode Pillow's PDF writer refuses; ``partial`` is what it had
    written by then."""

    def __init__(self, message: str, partial: bytes):
        super().__init__(message)
        self.partial = partial


def _string(b: bytes) -> bytes:
    """``PdfParser.pdf_repr`` of bytes."""
    return b"(" + b.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)") + b")"


def _date(t: time.struct_time) -> bytes:
    return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", t).encode("us-ascii") + b")"


def encode_pdf(pixels: np.ndarray, path: str) -> bytes:
    """The file Pillow writes to ``path`` for uint8 (H, W) L, (H, W, 3) RGB
    or (H, W, 4) RGBA pixels."""
    a = np.asarray(pixels)
    title = os.path.splitext(os.path.basename(path))[0]
    info = [(b"Title", _string(codecs.BOM_UTF16_BE + title.encode("utf_16_be")) if title else None),
            (b"CreationDate", _date(time.gmtime())), (b"ModDate", _date(time.gmtime()))]
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}

    def obj(num: int, entries, stream: bytes | None = None) -> None:
        offsets[num] = len(out)
        if stream is not None:
            entries = entries + [(b"Length", b"%d" % len(stream))]
        out.extend(b"%d 0 obj<<\n" % num)
        out.extend(b"".join(b"/%s %s\n" % (k, v) for k, v in entries if v is not None))
        out.extend(b">>")
        if stream is not None:
            out.extend(b"stream\n" + stream + b"\nendstream\n")
        out.extend(b"endobj\n")

    obj(4, [(b"Type", b"/Catalog"), (b"Pages", b"5 0 R")])
    obj(5, [(b"Type", b"/Pages"), (b"Count", b"1"), (b"Kids", b"[ 2 0 R ]")])
    if a.dtype == np.uint8 and a.ndim == 2:
        kind, procset, stream = [(b"Filter", b"/DCTDecode"), (b"BitsPerComponent", b"8"),
                                 (b"ColorSpace", b"/DeviceGray")], b"ImageB", encode_jpeg(a)
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        kind, procset, stream = [(b"Filter", b"/DCTDecode"), (b"BitsPerComponent", b"8"),
                                 (b"ColorSpace", b"/DeviceRGB")], b"ImageC", encode_jpeg(a)
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 4:
        kind, procset = [(b"Filter", b"/JPXDecode"), (b"SMaskInData", b"1")], b"ImageC"
        stream = encode_jpeg2000(a, "jp2")
    else:
        mode = "I;16" if a.dtype == np.uint16 else f"of a {a.dtype} array of shape {a.shape}"
        raise PdfModeError(f"cannot save mode {mode}", bytes(out))
    h, w = a.shape[:2]
    obj(1, [(b"Type", b"/XObject"), (b"Subtype", b"/Image"), (b"Width", b"%d" % w),
            (b"Height", b"%d" % h)] + kind, stream)
    resources = b"<<\n/ProcSet [ /PDF /%s ]\n/XObject <<\n/image 1 0 R\n>>\n>>" % procset
    width, height = w * 72.0 / 72.0, h * 72.0 / 72.0
    obj(2, [(b"Resources", resources),
            (b"MediaBox", b"[ 0 0 %s %s ]" % (repr(width).encode(), repr(height).encode())),
            (b"Contents", b"3 0 R"), (b"Type", b"/Page"), (b"Parent", b"5 0 R")])
    obj(3, [], b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (width, height))
    obj(6, info)
    start = len(out)
    out.extend(b"xref\n0 7\n0000000000 65536 f \n")
    out.extend(b"".join(b"%010d 00000 n \n" % offsets[n] for n in range(1, 7)))
    out.extend(b"trailer\n<<\n/Root 4 0 R\n/Size 7\n/Info 6 0 R\n>>\nstartxref\n%d\n%%%%EOF" % start)
    return bytes(out)
