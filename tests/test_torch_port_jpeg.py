"""Port parity: the JPEG decoders (utils/jpeg.py in numpy, csrc/jpeg_decode.cpp
through utils/jpeg_cext.py) against Pillow, which the JAX package reads
every JPEG with.

A matrix of files that Pillow writes here: subsampling 4:4:4, 4:2:2, 4:2:0
and grayscale, quality 50-100, odd sizes, optimized Huffman tables, restart
markers by blocks and by rows, progressive scans and EXIF/ICC segments.
Pillow writes no 4:1:1 or 4:4:0 file (its "4:1:1" is 4:2:0), no
arithmetic-coded, lossless or YCCK file, so those come from the encoders of
tests/torch_port_make_jpeg_fixtures.py (a baseline Huffman one, T.81's
arithmetic coder as jcarith.c writes it, sequential and progressive, and a
lossless one), and Pillow decodes them for the reference. CMYK files come
from Pillow, Adobe's and the encoder's. The numpy decoder runs at the small
sizes, the library at all of them. Then the committed fixtures against their
stored arrays, and those arrays against Pillow's decode of the files; then
each mode Pillow refuses, refused by Pillow and by both decoders with a
named error; block smoothing of progressive files cut short, as Pillow
smooths them.

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


S420, S422 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
# (name, image kind, encode keywords): arithmetic coding, sequential and progressive
ARITH_CASES = [
    ("444", "rgb", {}),
    ("420_restart", "rgb", dict(sampling=S420, restart=3)),
    ("422_dac", "rgb", dict(sampling=S422, dac=(2, 5, 1), quality=95)),
    ("440_q50", "rgb", dict(sampling=((1, 2), (1, 1), (1, 1)), quality=50)),
    ("gray_dac_restart", "gray", dict(dac=(0, 0, 63), restart=7)),
    ("adobe_rgb", "rgb", dict(colour="rgb")),
    ("progressive_420", "rgb", dict(sampling=S420, progressive=True)),
    ("progressive_422_restart_dac", "rgb", dict(sampling=S422, progressive=True, restart=2,
                                                dac=(1, 3, 2))),
    ("progressive_gray_restart", "gray", dict(progressive=True, restart=5, quality=95)),
    ("progressive_ycck", "cmyk", dict(colour="ycck", progressive=True)),
    ("cmyk_restart", "cmyk", dict(colour="cmyk", restart=4)),
]


def _image(kind: str, size, seed: int) -> np.ndarray:
    if kind == "cmyk":
        return fx.cmyk_content(*size, seed=seed)
    return fx.content(*size, seed=seed, gray=kind == "gray")


@pytest.mark.parametrize("name,kind,kw", ARITH_CASES, ids=[c[0] for c in ARITH_CASES])
def test_arithmetic_coding_equals_pillow(name, kind, kw):
    for i, size in enumerate(SIZES):
        data = fx.encode(_image(kind, size, seed=i + 30), arithmetic=True, **kw)
        assert data[data.index(b"\xff\xc9" if not kw.get("progressive") else b"\xff\xca")]
        ref = fx.pillow_decode(data)
        for decode in (jpeg.decode, jpeg_cext.decode):
            got = decode(data)
            assert got.shape == ref.shape and np.array_equal(got, ref), decode.__module__


def test_library_decodes_arithmetic_coding_at_frame_size():
    for kw in (dict(sampling=S420), dict(sampling=S420, progressive=True, restart=40)):
        data = fx.encode(fx.content(*fx.FRAME, seed=8), arithmetic=True, quality=95, **kw)
        assert np.array_equal(jpeg_cext.decode(data), fx.pillow_decode(data))


# (name, image kind, encode_lossless keywords); the predictors 1-7 each once at least
LOSSLESS_CASES = [
    ("gray_p1", "gray", dict(predictor=1)),
    ("gray_p2_pt3", "gray", dict(predictor=2, point_transform=3)),
    ("rgb_p3", "rgb", dict(predictor=3)),
    ("rgb_p4_restart", "rgb", dict(predictor=4, restart=-2)),
    ("adobe_rgb_p5", "rgb", dict(predictor=5, colour="rgb")),
    ("rgb_p6_420", "rgb", dict(predictor=6, sampling=S420)),
    ("rgb_p7_pt1_422_restart", "rgb", dict(predictor=7, point_transform=1, sampling=S422,
                                           restart=-1)),
    ("gray_p7_pt7", "gray", dict(predictor=7, point_transform=7)),
    ("cmyk_p5", "cmyk", dict(predictor=5)),
    ("cmyk_plain_p6_pt2", "cmyk", dict(predictor=6, point_transform=2, colour="cmyk_plain")),
]


@pytest.mark.parametrize("name,kind,kw", LOSSLESS_CASES, ids=[c[0] for c in LOSSLESS_CASES])
def test_lossless_coding_equals_pillow(name, kind, kw):
    """restart -n: n MCU rows an interval."""
    for i, size in enumerate(SIZES):
        args = dict(kw)
        if args.get("restart", 0) < 0:
            sampling = args.get("sampling") or ((1, 1),)
            per_row = size[1] if kind == "gray" else -(-size[1] // max(h for h, _ in sampling))
            args["restart"] *= -per_row
        data = fx.encode_lossless(_image(kind, size, seed=i + 40), **args)
        ref = fx.pillow_decode(data)
        for decode in (jpeg.decode, jpeg_cext.decode):
            got = decode(data)
            assert got.shape == ref.shape and np.array_equal(got, ref), decode.__module__


# four components: Pillow's CMYK writes (Adobe, inverted samples) and the encoder's
FOUR_CASES = [
    ("pillow_q75", lambda img: fx.pillow_jpeg(img, quality=75)),
    ("pillow_q95_progressive", lambda img: fx.pillow_jpeg(img, quality=95, progressive=True)),
    ("pillow_restart_optimize", lambda img: fx.pillow_jpeg(img, restart_marker_blocks=2,
                                                           optimize=True)),
    ("ycck", lambda img: fx.encode(img, colour="ycck")),
    ("ycck_2211_restart", lambda img: fx.encode(img, ((2, 2), (1, 1), (1, 1), (2, 2)),
                                                colour="ycck", restart=3)),
    ("cmyk_no_app14_1122", lambda img: fx.encode(img, ((1, 1), (1, 2), (2, 1), (2, 2)),
                                                 colour="cmyk_plain")),
]


@pytest.mark.parametrize("name,write", FOUR_CASES, ids=[c[0] for c in FOUR_CASES])
def test_four_components_equal_pillow(name, write):
    for i, size in enumerate(SIZES):
        data = write(fx.cmyk_content(*size, seed=i + 50))
        im = Image.open(io.BytesIO(data))
        assert im.mode == "CMYK"
        ref = np.asarray(im)
        for decode in (jpeg.decode, jpeg_cext.decode):
            got = decode(data)
            assert got.shape == (*size, 4) and np.array_equal(got, ref), decode.__module__
        assert jpeg.MODES[got.shape[2]] == im.mode


def test_cmyk_to_rgb_equals_pillow_on_every_channel_and_k_pair():
    """Pillow's convert("RGB") from CMYK: each output channel depends on one
    input channel and K only, so 256 x 256 pairs cover every case."""
    from cosypose_tpu_torch.data.pillow_ops import cmyk_to_rgb

    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, 255 - c, (c * 37) % 256, k], -1).astype(np.uint8)
    ref = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    got = cmyk_to_rgb(cmyk)
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    assert len({(int(a), int(b)) for a, b in zip(cmyk[..., 0].ravel(), k.ravel())}) == 65536


def test_imread_names_the_mode(tmp_path):
    """A JPEG's four channels are CMYK, a PNG's RGBA: the format says so."""
    (tmp_path / "c.jpg").write_bytes(fx.pillow_jpeg(fx.cmyk_content(21, 30, 1)))
    cases = {"c.jpg": "CMYK"}
    for mode, shape in (("RGBA", (21, 30, 4)), ("LA", (21, 30, 2)), ("L", (21, 30)),
                        ("RGB", (21, 30, 3))):
        Image.fromarray(np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8),
                        mode).save(tmp_path / f"{mode}.png")
        cases[f"{mode}.png"] = mode
    Image.fromarray(np.full((5, 6), 40000, np.uint16)).save(tmp_path / "d.png")
    cases["d.png"] = "I;16"
    for name, mode in cases.items():
        image, got = png.imread(tmp_path / name, with_mode=True)
        with Image.open(tmp_path / name) as im:
            assert got == mode == im.mode.replace("I;16B", "I;16")
            assert np.array_equal(image, np.asarray(im))
        assert np.array_equal(png.imread(tmp_path / name), image)


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
    img = fx.content(21, 30, 1)
    sof = base.index(b"\xff\xc0")
    cases = {f"{kind} coding (SOF{m - 0xC0}) is not decoded (marker 0xFF{m:02X})":
             _patched(base, 0xC0, m)
             for kind, m in [("hierarchical", 0xC5), ("hierarchical", 0xC6),
                             ("hierarchical", 0xC7), ("lossless arithmetic", 0xCB),
                             ("hierarchical", 0xCD), ("hierarchical", 0xCE),
                             ("hierarchical", 0xCF)]}
    cases.update({
        "hierarchical coding (DHP) is not decoded (marker 0xFFDE)":
            base[:2] + fx._segment(0xDE, bytes([8, 0, 37, 0, 53, 1, 1, 0x11, 0])) + base[2:],
        "hierarchical coding (EXP) is not decoded (marker 0xFFDF)":
            base[:sof] + fx._segment(0xDF, bytes([0x11])) + base[sof:],
        "12-bit precision is not decoded (marker 0xFFC0": _sof_payload_patched(base, 0, 12),
        "2 components are not decoded (marker 0xFFC0; 1, 3 or 4)":
            fx.encode(img[..., :2], colour="two"),
        "lossless coding (SOF3) of YCbCr colour is not decoded":
            fx.encode_lossless(img, 1, colour="ycc"),
        "lossless coding (SOF3) of YCCK colour is not decoded":
            fx.encode_lossless(fx.cmyk_content(21, 30, 1), 2, colour="ycck"),
        "a lossless restart interval of 5 MCUs is not a whole number of MCU rows (30 MCUs)":
            fx.encode_lossless(img, 3, restart=5),
        "truncated JPEG data": base[:len(base) // 2],
        "corrupt JPEG data": base[:-40] + b"\xff\x00" * 15 + b"\xff\xd9",
    })
    return cases


# what Pillow raises for each mode it refuses (utils/jpeg.py's table)
PILLOW_REFUSES = {"12-bit precision": "UnidentifiedImageError",
                  "2 components": "UnidentifiedImageError", "coding": "OSError",
                  "lossless restart": "OSError"}


def _pillow_verdict(what: str):
    return next((v for k, v in PILLOW_REFUSES.items() if k in what), None)


@pytest.mark.parametrize("what", list(_refused_cases()))
def test_refused_modes_raise_a_named_error(what, tmp_path):
    """Both decoders raise the same named error; for a mode (not damaged
    data), Pillow refuses the file too."""
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
    verdict = _pillow_verdict(what)
    if verdict is not None:
        with pytest.raises(OSError) as e:
            fx.pillow_decode(data)
        assert type(e.value).__name__ == verdict


def test_image_size_of_refused_modes_reads_the_header():
    cases = _refused_cases()
    assert jpeg.image_size(cases["hierarchical coding (SOF5) is not decoded (marker 0xFFC5)"]) \
        == (37, 53)
    lossless = cases["lossless coding (SOF3) of YCbCr colour is not decoded"]
    assert jpeg.image_size(lossless) == (21, 30)


# (size, subsampling, quality, scans kept): the cuts leave AC bits unknown, the
# first one all of them (the DC estimated too); narrow frames take the
# window's edge rows and columns (one or two blocks across, few iMCU rows)
SMOOTHING_CASES = [((121, 97), "4:2:0", 75, 4), ((121, 97), "4:2:0", 75, 1),
                   ((64, 64), "4:4:4", 90, 2), ((37, 53), "gray", 75, 3),
                   ((37, 53), "gray", 50, 1), ((16, 16), "4:4:4", 30, 5),
                   ((17, 9), "4:2:0", 100, 6), ((9, 17), "4:2:2", 30, 3),
                   ((40, 24), "4:2:0", 75, 7), ((5, 30), "4:2:2", 100, 2)]


@pytest.mark.parametrize("size,sub,quality,n_scans", SMOOTHING_CASES)
def test_block_smoothing_equals_pillow(size, sub, quality, n_scans):
    """libjpeg-turbo smooths the blocks of a progressive file whose scans
    leave low-frequency AC bits unknown (jdcoefct.c decompress_smooth_data):
    both decoders equal Pillow's."""
    data = fx.progressive_cut(size, seed=quality + n_scans, n_scans=n_scans, quality=quality,
                              subsampling=sub)
    assert jpeg._smoothing_ok(jpeg._read(data, "<bytes>", header_only=False))
    ref = fx.pillow_decode(data)
    for decode in (jpeg.decode, jpeg_cext.decode):
        got = decode(data)
        assert got.shape == ref.shape and np.array_equal(got, ref), decode.__module__


def test_block_smoothing_of_arithmetic_coded_cuts_equals_pillow():
    prog = fx.encode(fx.content(37, 53, seed=3), S420, arithmetic=True, progressive=True,
                     restart=3)
    sos = [i for i in range(len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xDA]
    for cut in sos[1:]:
        data = prog[:cut] + b"\xff\xd9"
        ref = fx.pillow_decode(data)
        for decode in (jpeg.decode, jpeg_cext.decode):
            assert np.array_equal(decode(data), ref), (cut, decode.__module__)


def test_library_build_is_cached_by_source_hash():
    first = jpeg_cext.build_library()
    assert first == jpeg_cext.build_library() and first.name.startswith("libcosypose_jpeg_")
    assert not list(first.parent.glob("libcosypose_jpeg_*.*.so"))   # no temporary left
