"""Page files without PIL: the port's PNG reader and writer
(``models/png.py``), its PIL-exact bicubic resize and host patch packing
(``models/processor.py``), and their use by ``TorchPreprocessor`` and
``TorchOCRBackend._pack_one``.

Every comparison is exact (uint8 or float32 bit-equality, equal token
ids): PIL is the reference of the reader and the resize (the JAX package
calls it), the JAX package's ``pack_image`` and ``_pack_one`` of the
packing.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    TPUPreprocessor)
from handwritten_ocr_tpu.models.processor import pack_image as jax_pack_image
from handwritten_ocr_tpu.models.qwen25vl.model import VLModel as JaxVLModel
from handwritten_ocr_tpu_torch.engine.torch_engines import (TorchOCRBackend,
                                                            TorchPreprocessor)
from handwritten_ocr_tpu_torch.models import png
from handwritten_ocr_tpu_torch.models.processor import (load_image_rgb,
                                                        pack_image,
                                                        resize_bicubic)
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
from torch_port_tiny import configs, jax_tree, port_tree

from pathlib import Path

CONTRACT_PAGES = sorted((Path(__file__).resolve().parent.parent
                         / ".contract_pages").glob("page*.png"))
MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _samples(channels, height=13, width=17, seed=0):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (height, width, channels), dtype=np.uint8)
    image[3:6] = 7                     # flat rows: small differences
    return image


def _pil(path):
    with Image.open(path) as img:
        mode = img.mode
        samples = np.asarray(img)
        rgb = np.asarray(img.convert("RGB"))
    return mode, samples if samples.ndim == 3 else samples[..., None], rgb


@pytest.mark.parametrize("kind", range(5), ids=["none", "sub", "up", "avg",
                                               "paeth"])
@pytest.mark.parametrize("channels", sorted(MODES), ids=MODES.values())
def test_reader_equals_pil_on_every_colour_type_and_filter(tmp_path, channels,
                                                           kind):
    image = _samples(channels, seed=channels * 5 + kind)
    path = tmp_path / "page.png"
    png.write_png(path, image, kind)
    mode, samples, rgb = _pil(path)
    assert mode == MODES[channels]
    assert np.array_equal(png.read_png(path), samples)
    assert np.array_equal(samples, image)
    assert np.array_equal(load_image_rgb(path), rgb)


def test_reader_equals_pil_on_mixed_filters_and_pil_written_files(tmp_path):
    image = _samples(3, height=40, width=31, seed=9)
    path = tmp_path / "mixed.png"
    png.write_png(path, image, [y % 5 for y in range(40)])
    assert np.array_equal(png.read_png(path), image)
    for channels in sorted(MODES):       # PIL's own encoder
        path = tmp_path / f"pil{channels}.png"
        img = _samples(channels, height=64, width=48, seed=channels)
        Image.fromarray(img[..., 0] if channels == 1 else img,
                        MODES[channels]).save(path)
        assert np.array_equal(png.read_png(path), _pil(path)[1])
        assert np.array_equal(load_image_rgb(path), _pil(path)[2])


@pytest.mark.parametrize("path", CONTRACT_PAGES, ids=lambda p: p.name)
def test_reader_equals_pil_on_the_contract_pages(path):
    assert np.array_equal(load_image_rgb(path), _pil(path)[2])


def _rewrite_header(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (CRC recomputed)."""
    width, height, depth, color, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    values = dict(width=width, height=height, depth=depth, color=color,
                  comp=comp, filt=filt, interlace=interlace) | fields
    header = struct.pack(">IIBBBBB", *values.values())
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + header) & 0xFFFFFFFF)
    return data[:16] + header + crc + data[33:]


def test_unsupported_features_raise_naming_them(tmp_path):
    image = _samples(3)
    path = tmp_path / "page.png"
    png.write_png(path, image)
    data = path.read_bytes()
    with pytest.raises(ValueError, match="interlacing"):
        png.read_png(_rewrite_header(data, interlace=1))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(_rewrite_header(data, depth=16))
    Image.fromarray(image).convert("P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="palette"):
        load_image_rgb(tmp_path / "palette.png")
    broken = bytearray(data)
    broken[40] ^= 0xFF                             # inside the IDAT payload
    with pytest.raises(ValueError, match="CRC mismatch"):
        png.read_png(bytes(broken))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(b"GIF89a" + data[6:])


def test_other_formats_load_through_pil_and_name_it_when_absent(tmp_path,
                                                                monkeypatch):
    import sys
    path = tmp_path / "page.bmp"
    Image.fromarray(_samples(3)).save(path)
    assert np.array_equal(load_image_rgb(path), _pil(path)[2])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL"):
        load_image_rgb(path)
    assert load_image_rgb(CONTRACT_PAGES[0]).shape == (924, 672, 3)


SIZES = [((924, 672), (924, 672)),       # already aligned: no pass runs
         ((924, 672), (1148, 840)),      # up
         ((1600, 1200), (1148, 840)),    # down (the smart-resize target)
         ((101, 57), (56, 84)),          # odd ratios, down and up
         ((37, 300), (37, 140)),         # horizontal pass only
         ((300, 37), (301, 37))]         # vertical pass only


@pytest.mark.parametrize("size,target", SIZES, ids=str)
def test_resize_is_bit_equal_to_pil(size, target):
    rng = np.random.default_rng(sum(size))
    image = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(image).resize(target[::-1],
                                                    Image.BICUBIC))
    assert np.array_equal(resize_bicubic(image, target), want)
    got = resize_bicubic(torch.from_numpy(image), target)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


def test_resize_takes_gray_and_float_pages_as_the_jax_package_does():
    from handwritten_ocr_tpu.models.processor import (
        resize_bicubic as jax_resize)
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (50, 40), dtype=np.uint8)
    assert np.array_equal(resize_bicubic(gray, (70, 28)),
                          jax_resize(gray, (70, 28)))
    floats = rng.normal(128, 90, (30, 30, 3))
    assert np.array_equal(resize_bicubic(floats, (56, 56)),
                          jax_resize(floats, (56, 56)))


@pytest.mark.parametrize("shape", [(1000, 700, 3), (300, 200), (924, 672, 3),
                                   (90, 70, 3)], ids=str)
def test_pack_image_equals_jax(shape):
    rng = np.random.default_rng(shape[0])
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    got, want = pack_image(image), jax_pack_image(image)
    assert got.grid == want.grid and got.num_llm_tokens == want.num_llm_tokens
    assert got.patches.dtype == want.patches.dtype == np.float32
    assert np.array_equal(got.patches, want.patches)


def test_preprocessor_loads_and_resizes_a_page_file_as_jax(tmp_path):
    rng = np.random.default_rng(2)
    page = np.clip(rng.normal(235, 8, (301, 203, 3)), 0, 255).astype(np.uint8)
    path = str(tmp_path / "page.png")
    Image.fromarray(page).save(path)
    got = TorchPreprocessor(device="cpu")._load_aligned(path)
    want = np.asarray(TPUPreprocessor()._load_aligned(path))
    assert got.shape[0] % 28 == 0 and got.shape[1] % 28 == 0
    assert np.array_equal(got.numpy(), want)


def test_unaligned_page_reads_as_jax_pack_one():
    """A raw unaligned page (no preprocessor) through both engines: each
    packs it on the host (smart resize + bicubic); the greedy tokens are
    equal."""
    pixels = dict(min_pixels=28 * 28, max_pixels=112 * 112)
    jax_cfg, port_cfg = configs()
    tree = jax_tree(jax_cfg, seed=13)
    rng = np.random.default_rng(4)
    pages = [rng.integers(0, 256, (61, 95, 3), dtype=np.uint8),
             rng.integers(0, 256, (61, 95), dtype=np.uint8)]

    class Spelling:
        from handwritten_ocr_tpu_torch.models.processor import (
            ByteTokenizer as _Base)
        _base = _Base()

        def encode(self, text):
            return self._base.encode(text)

        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    with jax.default_matmul_precision("highest"):
        want = JaxOCRBackend(JaxVLModel(tree, jax_cfg), Spelling(),
                             **pixels).read_batch(pages, "Read.", 6)
    backend = TorchOCRBackend(
        VLModel(port_tree(jax.tree_util.tree_map(np.asarray, tree)), port_cfg),
        Spelling(), device="cpu", kv_quant=False, **pixels)
    for page in pages:
        patches, grid = backend._pack_one(page)
        host = jax_pack_image(page, **pixels)
        assert grid == host.grid
        assert np.array_equal(patches.numpy(), host.patches)
    assert backend.read_batch(pages, "Read.", 6) == want
