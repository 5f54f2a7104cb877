"""Port parity: the JPEG decoders (utils/jpeg.py in numpy, csrc/jpeg_decode.cpp
through utils/jpeg_cext.py) against Pillow, which the JAX package reads
every JPEG with.

A matrix of files that Pillow writes here: subsampling 4:4:4, 4:2:2, 4:2:0
and grayscale, quality 50-100, odd sizes, optimized Huffman tables, restart
markers by blocks and by rows, progressive scans and EXIF/ICC segments.
Pillow writes no 4:1:1 or 4:4:0 file (its "4:1:1" is 4:2:0), so those come
from the baseline encoder of tests/torch_port_make_jpeg_fixtures.py, and
Pillow decodes them for the reference. The numpy decoder runs at the small
sizes, the library at all of them. Then the committed fixtures against their
stored arrays, and those arrays against Pillow's decode of the files; the
named errors for the modes neither decoder takes.

Tolerance: none. Every decode is byte-equal to Pillow's (np.array_equal).
"""

import io

import numpy as np
import pytest
from PIL import Image

from cosypose_tpu_torch.utils import jpeg, jpeg_cext, png
from tests import torch_port_make_jpeg_fixtures as fx

SUBSAMPLINGS = ["4:4:4", "4:2:2", "4:2:0", "4:1:1", "gray"]
QUALITIES = [50, 75, 95, 100]
OPTIONS = ["plain", "optimize", "restart_blocks", "restart_rows", "progressive", "exif_icc"]
SIZES = [(37, 53), (121, 97)]
ICC = bytes(range(256)) * 12   # Pillow writes the profile's bytes as they are, over two APP2s


def _exif() -> bytes:
    ex = Image.Exif()
    ex[0x010F] = "cosypose"          # Make
    ex[0x0112] = 6                   # Orientation: Pillow's open does not apply it
    return ex.tobytes()


def _app1(payload: bytes) -> bytes:
    return bytes([0xFF, 0xE1]) + (len(payload) + 2).to_bytes(2, "big") + payload


def write_case(size, sub, quality, option, seed=0) -> bytes:
    img = fx.content(*size, seed=seed, gray=sub == "gray")
    if sub == "4:1:1":   # the encoder of the fixtures: baseline, fixed-length codes
        kw = {"restart_blocks": dict(restart=3), "restart_rows": dict(restart=_mcus_a_row(size)),
              "exif_icc": dict(app=_app1(b"Exif\0\0" + _exif()))}.get(option, {})
        return fx.encode_baseline(img, ((4, 1), (1, 1), (1, 1)), quality=quality, **kw)
    kw = dict(quality=quality)
    if sub != "gray":
        kw["subsampling"] = sub
    kw.update({"plain": {}, "optimize": dict(optimize=True),
               "restart_blocks": dict(restart_marker_blocks=3),
               "restart_rows": dict(restart_marker_rows=1),
               "progressive": dict(progressive=True),
               "exif_icc": dict(exif=_exif(), icc_profile=ICC)}[option])
    return fx.pillow_jpeg(img, **kw)


def _mcus_a_row(size) -> int:
    """MCUs in one MCU row of a 4:1:1 frame (32 x 8 pixels an MCU)."""
    return -(-size[1] // 32)


CASES = [(s, q, o) for s in SUBSAMPLINGS for q in QUALITIES for o in OPTIONS
         if s != "4:1:1" or o in ("plain", "restart_blocks", "restart_rows", "exif_icc")]


@pytest.mark.parametrize("sub,quality,option", CASES)
def test_decoders_equal_pillow(sub, quality, option):
    for i, size in enumerate(SIZES):
        data = write_case(size, sub, quality, option, seed=quality + i)
        ref = fx.pillow_decode(data)
        assert ref.shape == (size if sub == "gray" else (*size, 3))
        for decode in (jpeg.decode, jpeg_cext.decode):
            got = decode(data)
            assert got.dtype == np.uint8 and got.shape == ref.shape, decode.__module__
            assert np.array_equal(got, ref), (decode.__module__, int((got != ref).sum()))


@pytest.mark.parametrize("sub,option", [("4:2:0", "plain"), ("4:2:0", "progressive"),
                                        ("4:2:2", "restart_rows"), ("4:4:4", "optimize"),
                                        ("gray", "progressive"), ("4:1:1", "restart_blocks")])
def test_library_equals_pillow_at_frame_size(sub, option):
    data = write_case(fx.FRAME, sub, 95, option, seed=7)
    assert np.array_equal(jpeg_cext.decode(data), fx.pillow_decode(data))


def test_decoders_take_sampling_modes_pillow_does_not_write():
    """4:4:0 (libjpeg-turbo's h1v2 fancy filter), 2x2 luma with 2x1 and
    1x2 chroma, a 4:2:0 frame two pixels wide (fancy upsampling off), and
    Adobe RGB (APP14 transform 0, no colour conversion)."""
    cases = [(fx.content(45, 37, 1), ((1, 2), (1, 1), (1, 1)), {}),
             (fx.content(33, 51, 2), ((2, 2), (2, 1), (1, 2)), {}),
             (fx.content(19, 2, 3), ((2, 2), (1, 1), (1, 1)), {}),
             (fx.content(19, 4, 3), ((2, 1), (1, 1), (1, 1)), {}),
             (fx.content(29, 41, 4), ((1, 1), (1, 1), (1, 1)), dict(adobe_rgb=True, restart=2))]
    for img, sampling, kw in cases:
        data = fx.encode_baseline(img, sampling, **kw)
        ref = fx.pillow_decode(data)
        assert np.array_equal(jpeg.decode(data), ref), sampling
        assert np.array_equal(jpeg_cext.decode(data), ref), sampling


def test_committed_fixtures_equal_their_stored_arrays():
    expected = fx.expected()
    assert sorted(expected) == sorted(str(p.relative_to(fx.ROOT)) for p in fx.fixture_paths())
    assert len([k for k in expected if k.startswith("VOCdevkit/")]) == 6
    for rel, ref in expected.items():
        data = (fx.ROOT / rel).read_bytes()
        assert np.array_equal(jpeg_cext.decode(data, rel), ref), rel
        if ref.shape[0] * ref.shape[1] <= 480 * 640:
            assert np.array_equal(jpeg.decode(data, rel), ref), rel


def test_stored_arrays_equal_pillow_on_the_committed_files():
    for rel, ref in fx.expected().items():
        im = Image.open(fx.ROOT / rel)
        assert np.array_equal(np.asarray(im), ref), rel
        assert png.image_size(fx.ROOT / rel) == ref.shape[:2] == (im.height, im.width)


def test_imread_and_image_size_read_jpeg(tmp_path):
    data = write_case((37, 53), "4:2:0", 75, "plain")
    (tmp_path / "x.jpg").write_bytes(data)
    assert np.array_equal(png.imread(tmp_path / "x.jpg"), fx.pillow_decode(data))
    assert png.image_size(tmp_path / "x.jpg") == (37, 53) == jpeg.image_size(data)
    prog = write_case((121, 97), "gray", 50, "progressive")
    assert jpeg.image_size(prog) == (121, 97)


def _patched(data: bytes, marker: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, marker]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def _sof_payload_patched(data: bytes, offset: int, value: int) -> bytes:
    i = data.index(b"\xff\xc0") + 4 + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def _refused_cases():
    """{the message's words: the file}."""
    base = write_case((37, 53), "4:2:0", 75, "plain")
    prog = write_case((121, 97), "4:2:0", 75, "progressive")
    cmyk = io.BytesIO()
    Image.fromarray(fx.content(21, 30, 1)).convert("CMYK").save(cmyk, "JPEG")
    # the progressive file's first four scans: the AC bands' low bits stay unknown
    sos = [i for i in range(len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xDA]
    return {
        "arithmetic coding (SOF9) is not decoded (marker 0xFFC9)": _patched(base, 0xC0, 0xC9),
        "lossless coding (SOF3) is not decoded (marker 0xFFC3)": _patched(base, 0xC0, 0xC3),
        "hierarchical coding (SOF5) is not decoded (marker 0xFFC5)": _patched(base, 0xC0, 0xC5),
        "12-bit precision is not decoded (marker 0xFFC0": _sof_payload_patched(base, 0, 12),
        "four components (CMYK or YCCK) are not decoded (marker 0xFFC0)": cmyk.getvalue(),
        "truncated JPEG data": base[:len(base) // 2],
        "block smoothing": prog[:sos[4]] + b"\xff\xd9",
        "corrupt JPEG data": base[:-40] + b"\xff\x00" * 15 + b"\xff\xd9",
    }


@pytest.mark.parametrize("what", list(_refused_cases()))
def test_refused_modes_raise_a_named_error(what, tmp_path):
    data = _refused_cases()[what]
    messages = []
    for decode in (jpeg.decode, jpeg_cext.decode):
        with pytest.raises(jpeg.JPEGError) as e:
            decode(data, "frame.jpg")
        messages.append(str(e.value))
    assert messages[0] == messages[1] and messages[0].startswith("frame.jpg: ")
    assert what in messages[0], messages[0]
    (tmp_path / "frame.jpg").write_bytes(data)
    with pytest.raises(jpeg.JPEGError, match="frame.jpg"):
        png.imread(tmp_path / "frame.jpg")


def test_image_size_of_refused_modes_reads_the_header():
    cases = _refused_cases()
    assert jpeg.image_size(cases["arithmetic coding (SOF9) is not decoded (marker 0xFFC9)"]) \
        == (37, 53)
    cmyk = cases["four components (CMYK or YCCK) are not decoded (marker 0xFFC0)"]
    assert jpeg.image_size(cmyk) == (21, 30) == fx.pillow_decode(cmyk).shape[:2]


def test_library_build_is_cached_by_source_hash():
    first = jpeg_cext.build_library()
    assert first == jpeg_cext.build_library() and first.name.startswith("libcosypose_jpeg_")
    assert not list(first.parent.glob("libcosypose_jpeg_*.*.so"))   # no temporary left
