"""Sample sources and sinks: the seam where live SDR hardware plugs in.

The port's own copy of dvbt_tpu/io/source.py (which imports no JAX),
class for class and function for function; tests/test_torch_isolation.py
holds each equal to its original.  Anything with ``read(n) -> complex64
ndarray`` (the ``SampleSource`` protocol) can drive
``models.loopback.StreamingReceiver`` through ``apps/rx.py``; anything
with ``write(samples)`` (``SampleSink``) takes ``apps/tx.py``'s output.
The shipped implementations are file- and array-backed; ``open_source``
and ``open_sink`` map a CLI spec to one: a plain path is a raw-complex64
IQ file, and ``soapy://`` / ``usrp://`` / ``rtlsdr://`` dispatch to the
SoapySDR C-API binding in ``io/soapy.py`` (it needs libSoapySDR.so and a
driver module at run time).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class SampleSource(Protocol):
    """Streaming complex-baseband source.

    read(n) returns UP TO n complex64 samples; an empty array signals end
    of stream.  Implementations may block until samples are available
    (live hardware) — the receiver consumes whatever arrives.
    """

    def read(self, n: int) -> np.ndarray: ...

    def close(self) -> None: ...


class FileSource:
    """Raw interleaved-complex64 IQ file (GNU Radio file_source format)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")

    def read(self, n: int) -> np.ndarray:
        return np.fromfile(self._f, dtype=np.complex64, count=n)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArraySource:
    """In-memory source (tests, synthesized streams)."""

    def __init__(self, samples: np.ndarray):
        self._s = np.asarray(samples, np.complex64)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = self._s[self._pos: self._pos + n]
        self._pos += len(out)
        return out

    def close(self) -> None:
        self._pos = len(self._s)


_HW_SCHEMES = ("usrp://", "rtlsdr://", "soapy://")


def open_source(spec: str) -> SampleSource:
    """CLI spec -> SampleSource.  Plain path = IQ file; SDR URL schemes
    dispatch to the SoapySDR C-API binding (io/soapy.py): ``soapy://``
    takes raw device args, ``usrp://`` / ``rtlsdr://`` imply the uhd /
    rtlsdr driver.  Raises RuntimeError with install guidance when
    libSoapySDR.so is absent."""
    for scheme in _HW_SCHEMES:
        if spec.startswith(scheme):
            from . import soapy
            return soapy.SoapySource(spec)
    return FileSource(spec)


# --- TX side: sample sinks --------------------------------------------------


@runtime_checkable
class SampleSink(Protocol):
    """Streaming complex-baseband sink — the TX-side hardware seam
    (the reference's file→USRP flowgraphs; SURVEY.md §0).

    write(samples) consumes a complex64 ndarray; implementations may block
    on hardware back-pressure (a USRP wrapper would hand chunks to the
    vendor streamer at the 64/7 Msps pace)."""

    def write(self, samples: np.ndarray) -> None: ...

    def close(self) -> None: ...


class FileSink:
    """Raw interleaved-complex64 IQ file (GNU Radio file_sink format)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, samples: np.ndarray) -> None:
        np.asarray(samples, np.complex64).tofile(self._f)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArraySink:
    """In-memory sink (tests, loopback drives)."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def write(self, samples: np.ndarray) -> None:
        self._chunks.append(np.asarray(samples, np.complex64))

    def samples(self) -> np.ndarray:
        return (np.concatenate(self._chunks) if self._chunks
                else np.zeros((0,), np.complex64))

    def close(self) -> None:
        pass


def open_sink(spec: str) -> SampleSink:
    """CLI spec -> SampleSink.  Plain path = IQ file; SDR URL schemes
    dispatch to the SoapySDR TX binding (io/soapy.py)."""
    for scheme in _HW_SCHEMES:
        if spec.startswith(scheme):
            from . import soapy
            return soapy.SoapySink(spec)
    return FileSink(spec)
