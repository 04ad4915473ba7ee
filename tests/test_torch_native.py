"""The port's native host runtime (dvbt_tpu_torch/native): ring buffer
semantics and the TS sync search, as tests/test_native.py holds the JAX
package's, plus where the library is built: under build/dvbt_tpu_torch/,
never beside the JAX package's source."""

import os

import numpy as np

from dvbt_tpu_torch import native
from dvbt_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_under_the_port_build_dir():
    lib = native.library()
    path = native.build()
    assert lib is not None and path.exists()
    assert path.parent == _build.BUILD_DIR
    assert str(path).startswith(os.path.join(REPO, "build", "dvbt_tpu_torch"))
    assert "dvbt_tpu" + os.sep + "native" not in str(path)
    assert path.name.startswith("libdvbt_native_")


def test_a_failed_build_raises_with_the_compiler_message(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "ringbuffer.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    try:
        native.build()
    except RuntimeError as e:
        assert "g++ failed" in str(e) and "ringbuffer.cc" in str(e)
    else:
        raise AssertionError("a broken source built")
    assert not list((tmp_path / "build").glob("*.so"))


def test_ring_roundtrip_and_wrap():
    rb = native.RingBuffer(capacity=1000, max_read=256, dtype=np.uint8)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 10_000, dtype=np.uint8)
    out = []
    pos = 0
    while pos < len(data) or rb.readable:
        if pos < len(data):
            pos += rb.write(data[pos: pos + 333])
        while rb.readable >= 100:
            view = rb.peek(100)
            out.append(np.array(view))
            rb.consume(100)
    got = np.concatenate(out)
    assert np.array_equal(got, data[: len(got)])
    assert len(got) == 10_000


def test_ring_peek_contiguous_across_wrap():
    rb = native.RingBuffer(capacity=256, max_read=128, dtype=np.uint8)
    rb.write(np.arange(200, dtype=np.uint8))
    rb.consume(200)
    # the next write wraps the power-of-two boundary (cap=256)
    rb.write(np.arange(100, dtype=np.uint8))
    v = rb.peek(100)
    assert v is not None and np.array_equal(v, np.arange(100, dtype=np.uint8))
    assert rb.peek(129) is None          # past max_read


def test_ring_complex_dtype_and_read():
    rb = native.RingBuffer(capacity=64, max_read=32, dtype=np.complex64)
    x = (np.arange(20) + 1j * np.arange(20)).astype(np.complex64)
    assert rb.write(x) == 20
    assert np.array_equal(rb.peek(20), x)
    assert np.array_equal(rb.read(8), x[:8])
    assert rb.readable == 12
    assert rb.write(np.zeros(100, np.complex64)) == 64 - 12   # full
    rb.close()


def test_ts_find_sync_and_quality():
    rng = np.random.default_rng(1)
    pk = rng.integers(0, 256, (30, 188), dtype=np.uint8)
    pk[:, 0] = 0x47
    pk[7, 0] = 0xB8  # a dispersal-inverted sync also counts
    stream = np.concatenate([rng.integers(0, 256, 101, dtype=np.uint8),
                             pk.reshape(-1)])
    off = native.ts_find_sync(stream, confirm=5)
    assert off == 101 or (stream[off] in (0x47, 0xB8)
                          and stream[off + 188] in (0x47, 0xB8))
    aligned = stream[101:]
    assert native.ts_find_sync(aligned, confirm=30) == 0
    assert native.ts_sync_quality(aligned) == 1.0
    assert native.ts_sync_quality(stream[:101 + 188 * 3]) < 1.0
    assert native.ts_find_sync(stream[:300], confirm=3) == -1
