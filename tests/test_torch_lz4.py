"""Parity of the port's native LZ4 block codec (``io/lz4.py`` over its own
build of ``ingest/native/lz4_block.cpp``) with the JAX package's, on the
CPU: the port's blobs are byte-identical to the reference's on the same
payloads, each package decodes the other's, truncated and oversized
headers are rejected (the oversized one before any allocation), and the
``lz4`` codec of ``io/vdi_io`` packs column segments and writes ``.npz``
artifacts that equal the reference's bytes and round-trip bit for bit.
Payloads made from a seed with numpy; comparisons exact. Skips without
a C++ toolchain, as the reference's ``tests/test_lz4.py`` does."""

import shutil

import numpy as np
import pytest
import torch

from scenery_insitu_tpu.core import vdi as jvdi
from scenery_insitu_tpu.io import lz4 as jlz4
from scenery_insitu_tpu.io import vdi_io as jio
from scenery_insitu_tpu_torch.core import vdi as tvdi
from scenery_insitu_tpu_torch.io import lz4 as tlz4
from scenery_insitu_tpu_torch.io import vdi_io as tio
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain (g++)")

_RNG = np.random.default_rng(3)
PAYLOADS = {
    "empty": b"",
    "tiny": b"ab",
    "zeros": b"\x00" * 4096,
    "text": b"the quick brown fox jumps over the lazy dog " * 64,
    "random": _RNG.bytes(4096),
    "sparse_f32": np.where(_RNG.random(4096) > 0.9, _RNG.random(4096),
                           0.0).astype(np.float32).tobytes(),
    # a repeat beyond the 64 KiB window must go out as literals
    "window": b"ABCDEFGHIJKLMNOP" * 4 + _RNG.bytes(70_000)
              + b"ABCDEFGHIJKLMNOP" * 4,
}


def _vdi(k=4, h=8, w=16, seed=0):
    rng = np.random.default_rng(seed)
    color = rng.random((k, 4, h, w), dtype=np.float32)
    depth = np.sort(rng.random((k, 2, h, w), dtype=np.float32) * 5, axis=1)
    empty = rng.random((k, 1, h, w)) < 0.5
    return (np.where(empty, 0.0, color).astype(np.float32),
            np.where(empty, np.inf, depth).astype(np.float32))


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_blobs_equal_the_reference_and_cross_decode(name):
    data = PAYLOADS[name]
    blob = tlz4.compress(data)
    assert blob == jlz4.compress(data)
    assert tlz4.decompress(jlz4.compress(data)) == data
    assert jlz4.decompress(blob) == data


def test_available_and_sizes_sweep():
    assert tlz4.available()
    rng = np.random.default_rng(0)
    for size in (1, 3, 12, 13, 15, 16, 255, 256, 65535, 65536, 200_000):
        base = rng.bytes(max(1, size // 17))
        data = (base * (size // len(base) + 1))[:size]
        blob = tlz4.compress(data)
        assert blob == jlz4.compress(data), size
        assert tlz4.decompress(blob) == data, size


def test_bad_headers_rejected():
    blob = tlz4.compress(b"hello world " * 100)
    with pytest.raises(ValueError):
        tlz4.decompress(blob[:len(blob) // 2])      # truncated stream
    with pytest.raises(ValueError, match="shorter than its size header"):
        tlz4.decompress(blob[:5])
    with pytest.raises(ValueError, match="trailing bytes"):
        tlz4.decompress(b"\x00" * 9)
    # an untrusted header claiming a terabyte: refused by the expansion
    # bound before any allocation, as the reference refuses it
    evil = (1 << 40).to_bytes(8, "little") + b"\x00" * 16
    for dec in (tlz4.decompress, jlz4.decompress):
        with pytest.raises(ValueError, match="max expansion"):
            dec(evil)


def test_vdi_segments_and_artifacts(tmp_path):
    """``pack_vdi_segments(codec="lz4")`` blobs and limits equal the
    reference's and unpack bit for bit in both packages; an lz4 ``.npz``
    written by each package is the same file and loads in the other."""
    color, depth = _vdi()
    tv = tvdi.VDI(torch.from_numpy(color), torch.from_numpy(depth))
    jv = jvdi.VDI(color, depth)
    tb, tcl, tdl = tio.pack_vdi_segments(tv, 4, codec="lz4")
    jb, jcl, jdl = jio.pack_vdi_segments(jv, 4, codec="lz4")
    assert tb == jb
    np.testing.assert_array_equal(tcl, jcl)
    np.testing.assert_array_equal(tdl, jdl)
    for unpack in (tio.unpack_vdi_segments, jio.unpack_vdi_segments):
        got = unpack(tb, 4, 8, 16, codec="lz4")
        np.testing.assert_array_equal(np.asarray(got.color), color)
        np.testing.assert_array_equal(np.asarray(got.depth), depth)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save_vdi(tpath, tv, codec="lz4")
    jio.save_vdi(jpath, jv, codec="lz4")
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    for load, path in ((tio.load_vdi, jpath), (jio.load_vdi, tpath)):
        vdi, _ = load(path)
        np.testing.assert_array_equal(np.asarray(vdi.color), color)
        np.testing.assert_array_equal(np.asarray(vdi.depth), depth)
