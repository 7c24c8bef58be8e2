"""EPS/PS and PDF in the port's codec (``assets/eps.py``,
``assets/pdf.py``) against Pillow 12.1.0 and the JAX package's
``ImageSaver``: the bytes of Pillow's ``save`` for L and RGB (EPS, PS)
and L, RGB and RGBA (PDF, with the clock fixed for both writers), widths
whose hex dump breaks its lines inside a row, PDF titles with ``(``,
``)``, ``\\`` and characters outside ASCII; the refusals, and what each
saver leaves in a file that was there before.
"""

import hashlib
import os

import numpy as np
import pytest

import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu_torch.assets import eps, pdf
from stillleben_tpu_torch.assets.image_fixtures import PDF_CLOCK, digests, jpeg2000_saver_sources
from stillleben_tpu_torch.assets.jpeg import encode_jpeg
from stillleben_tpu_torch.assets.jpeg2000 import encode_jpeg2000
from test_torch_image_saver_parity import run_both
from torch_image_fixtures import fixed_clock, pillow_file

pytest.importorskip("PIL.Image")
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SHAPES = ((2, 45), (1, 1), (3, 13), (4, 39), (5, 39, 3), (4, 13, 3), (2, 26, 3), (7, 40, 3))
NAMES = ("page.pdf", "t (x)é\\.pdf", "日本 (1).pdf", "a.b.PDF", "emoji\U0001F600.pdf")


def array(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("ext", (".eps", ".ps"))
@pytest.mark.parametrize("shape", SHAPES)
def test_eps_matches_pillow(shape, ext):
    a = array(shape, sum(shape))
    assert eps.encode_eps(a) == pillow_file(a, "x" + ext)


@pytest.mark.parametrize("channels", (1, 3, 4))
@pytest.mark.parametrize("name", NAMES)
def test_pdf_matches_pillow(name, channels):
    a = array((6, 9) if channels == 1 else (6, 9, channels), channels)
    with fixed_clock(PDF_CLOCK):
        assert pdf.encode_pdf(a, os.path.join("/no/such/dir", name)) == pillow_file(a, name)


def test_pdf_structure():
    """The image stream is the JPEG (L, RGB) or the JP2 (RGBA) of the same
    array; every xref offset points at its object; the clock is read at
    the save."""
    a = array((48, 64, 4), 7)
    for arr, stream in ((a[..., 0].copy(), encode_jpeg(a[..., 0].copy())),
                        (a[..., :3].copy(), encode_jpeg(a[..., :3].copy())),
                        (a, encode_jpeg2000(a, "jp2"))):
        data = pdf.encode_pdf(arr, "x.pdf")
        start = data.index(b"stream\n") + 7
        assert data[start: start + len(stream) + 11] == stream + b"\nendstream\n"
        xref = int(data.rsplit(b"startxref\n", 1)[1].split(b"\n")[0])
        rows = data[xref:].split(b"\n")[3:9]
        for num, row in enumerate(rows, 1):
            at = int(row[:10])
            assert data[at:].startswith(b"%d 0 obj" % num)
    with fixed_clock(PDF_CLOCK + 86400):
        assert b"(D:20231115221320Z)" in pdf.encode_pdf(a, "x.pdf")


@pytest.mark.parametrize("name", [n for n in jpeg2000_saver_sources() if n[-4:] in (".eps", ".pdf")
                                  or n.endswith(".ps")])
def test_saver_digests(name):
    a = jpeg2000_saver_sources()[name]
    with fixed_clock(PDF_CLOCK):
        data = pdf.encode_pdf(a, name) if name.endswith(".pdf") else eps.encode_eps(a)
    assert hashlib.sha256(data).hexdigest() == digests.JPEG2000_ENCODE[name]


def test_refusals():
    rgba, i16 = array((3, 5, 4), 1), np.zeros((3, 5), np.uint16)
    for a in (rgba, i16):
        with pytest.raises(ValueError, match="image mode is not supported"):
            eps.encode_eps(a)
    with pytest.raises(pdf.PdfModeError, match="cannot save mode I;16") as e:
        pdf.encode_pdf(i16, "x.pdf")
    assert e.value.partial.startswith(b"%PDF-1.4\n") and e.value.partial.endswith(b"endobj\n")


def test_saver_over_existing_files(tmp_path, capsys):
    """Where Pillow refuses the mode over a file that was there: EPS leaves
    it empty, PDF leaves the objects it wrote before refusing I;16; with no
    file there, neither leaves one."""
    depth = np.ones((3, 5), np.uint16)
    jobs = [("RGBA", array((3, 5, 4), 2), "rgba.eps"), ("I;16", depth, "depth.pdf"),
            ("I;16", depth, "depth.ps")]
    for d in ("existing", "fresh"):
        (tmp_path / d).mkdir()
    with fixed_clock(PDF_CLOCK):
        ref, ours = run_both(tmp_path / "existing", jobs, existing=b"previous")
        assert ours == ref and ref["rgba.eps"] == b"" and ref["depth.pdf"].startswith(b"%PDF")
        ref, ours = run_both(tmp_path / "fresh", jobs)
        assert ours == ref == {}
    assert capsys.readouterr().out.count("ImageSaver: failed to write") == 12
