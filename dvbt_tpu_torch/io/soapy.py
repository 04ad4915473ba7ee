"""SoapySDR-backed sample source and sink: the live-hardware half of the
IO seam (file -> USRP and RTL-SDR -> file operation).

The port's own copy of dvbt_tpu/io/soapy.py (which imports no JAX), with
one repair in ``_CtypesDevice.read``: an OVERFLOW return resets the
count of consecutive TIMEOUTs (the device is streaming), and more than
``READ_RETRIES`` consecutive OVERFLOWs raise ``RuntimeError`` ("readStream
stalled"), as ``write`` does for a stalled TX stream; the original retries
OVERFLOW without bound.  tests/test_torch_isolation.py holds everything
else equal to the original.

Three layers, so that the seam is testable without hardware:

  1. ``SoapySource`` / ``SoapySink`` implement the ``SampleSource`` /
     ``SampleSink`` protocols (io/source.py) over an abstract *device*
     with ``read(n) -> complex64`` / ``write(samples)`` / ``close()``.
  2. ``_CtypesDevice`` binds that device interface to the SoapySDR C API
     through ctypes (signatures of the SoapySDR >= 0.8 C ABI, where
     setupStream returns the stream handle).  It is built only when
     ``libSoapySDR.so`` is present.
  3. Tests inject a mock device: the protocol, URL parsing, chunking and
     end-of-stream behaviour run without any driver.

URL grammar (open_source/open_sink dispatch here):
    soapy://driver=rtlsdr,rate=9142857.14,freq=506e6[,gain=30][,channel=0]
    rtlsdr://...  == soapy://driver=rtlsdr,...
    usrp://...    == soapy://driver=uhd,...
Rate defaults to the DVB-T 8 MHz baseband rate 64e6/7.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

DVBT_RATE = 64e6 / 7
SOAPY_SDR_TX = 0
SOAPY_SDR_RX = 1

# SoapySDR error return codes (Errors.h of the C ABI). TIMEOUT and
# OVERFLOW are recoverable stream conditions — a reader must retry, not
# treat them as end-of-stream (one RX overflow at 9.14 Msps would
# otherwise silently terminate live reception).
SOAPY_SDR_TIMEOUT = -1
SOAPY_SDR_OVERFLOW = -4
SOAPY_SDR_UNDERFLOW = -7
_ERR_NAMES = {-1: "TIMEOUT", -2: "STREAM_ERROR", -3: "CORRUPTION",
              -4: "OVERFLOW", -5: "NOT_SUPPORTED", -6: "TIME_ERROR",
              -7: "UNDERFLOW"}


def parse_spec(spec: str) -> dict:
    """'scheme://k=v,k=v' -> args dict with scheme-implied driver."""
    scheme, _, rest = spec.partition("://")
    args: dict[str, str] = {}
    for part in filter(None, rest.split(",")):
        k, _, v = part.partition("=")
        args[k.strip()] = v.strip()
    if scheme == "rtlsdr":
        args.setdefault("driver", "rtlsdr")
    elif scheme == "usrp":
        args.setdefault("driver", "uhd")
    args.setdefault("rate", str(DVBT_RATE))
    return args


def _load_lib():
    name = ctypes.util.find_library("SoapySDR") or "libSoapySDR.so"
    try:
        return ctypes.CDLL(name)
    except OSError as e:
        raise RuntimeError(
            "SoapySDR runtime not found (libSoapySDR.so): install the "
            "SoapySDR core + a driver module (soapy-rtlsdr / uhd) to use "
            "live SDR sources; file and array sources need nothing.") from e


class _CtypesDevice:
    """One direction (RX or TX) of one SoapySDR device via the C ABI."""

    def __init__(self, args: dict, direction: int, lib=None):
        self._lib = lib or _load_lib()
        L = self._lib
        L.SoapySDRDevice_makeStrArgs.restype = ctypes.c_void_p
        L.SoapySDRDevice_makeStrArgs.argtypes = [ctypes.c_char_p]
        L.SoapySDRDevice_setSampleRate.restype = ctypes.c_int
        L.SoapySDRDevice_setSampleRate.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double]
        L.SoapySDRDevice_setFrequency.restype = ctypes.c_int
        L.SoapySDRDevice_setFrequency.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double,
            ctypes.c_void_p]
        L.SoapySDRDevice_setGain.restype = ctypes.c_int
        L.SoapySDRDevice_setGain.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double]
        L.SoapySDRDevice_setupStream.restype = ctypes.c_void_p
        L.SoapySDRDevice_setupStream.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t,
            ctypes.c_void_p]
        L.SoapySDRDevice_activateStream.restype = ctypes.c_int
        L.SoapySDRDevice_activateStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_size_t]
        for fn in ("SoapySDRDevice_readStream",
                   "SoapySDRDevice_writeStream"):
            getattr(L, fn).restype = ctypes.c_int
        L.SoapySDRDevice_readStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long]
        L.SoapySDRDevice_writeStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_long]
        # teardown signatures too — an unconfigured ctypes call passes
        # pointers as 32-bit C ints (truncation on 64-bit hosts)
        L.SoapySDRDevice_deactivateStream.restype = ctypes.c_int
        L.SoapySDRDevice_deactivateStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong]
        L.SoapySDRDevice_closeStream.restype = ctypes.c_int
        L.SoapySDRDevice_closeStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        L.SoapySDRDevice_unmake.restype = ctypes.c_int
        L.SoapySDRDevice_unmake.argtypes = [ctypes.c_void_p]

        dev_args = ",".join(f"{k}={v}" for k, v in args.items()
                            if k not in ("rate", "freq", "gain", "channel"))
        self._dev = L.SoapySDRDevice_makeStrArgs(dev_args.encode())
        if not self._dev:
            raise RuntimeError(f"SoapySDR device open failed: {dev_args!r}")
        self._dir = direction
        ch = int(args.get("channel", "0"))
        self._ch = ch

        def check(name, rc):
            if rc != 0:
                raise RuntimeError(
                    f"SoapySDR {name} failed: "
                    f"{_ERR_NAMES.get(rc, rc)} ({rc})")

        check("setSampleRate", L.SoapySDRDevice_setSampleRate(
            self._dev, direction, ch, float(args["rate"])))
        if "freq" in args:
            check("setFrequency", L.SoapySDRDevice_setFrequency(
                self._dev, direction, ch, float(args["freq"]), None))
        if "gain" in args:
            check("setGain", L.SoapySDRDevice_setGain(
                self._dev, direction, ch, float(args["gain"])))
        chans = (ctypes.c_size_t * 1)(ch)
        self._stream = L.SoapySDRDevice_setupStream(
            self._dev, direction, b"CF32", chans, 1, None)
        if not self._stream:
            raise RuntimeError("SoapySDR setupStream failed")
        check("activateStream", L.SoapySDRDevice_activateStream(
            self._dev, self._stream, 0, 0, 0))
        self._flags = ctypes.c_int(0)
        self._time = ctypes.c_longlong(0)

    # consecutive TIMEOUT retries before giving up (1 s timeout each), and
    # consecutive OVERFLOW returns before the RX stream counts as stalled
    READ_RETRIES = 8

    def read(self, n: int) -> np.ndarray:
        buf = np.empty(n, np.complex64)
        ptrs = (ctypes.c_void_p * 1)(buf.ctypes.data)
        timeouts = overflows = 0
        while True:
            got = self._lib.SoapySDRDevice_readStream(
                self._dev, self._stream, ptrs, n,
                ctypes.byref(self._flags), ctypes.byref(self._time),
                1_000_000)
            if got >= 0:
                return buf[:got]
            if got == SOAPY_SDR_OVERFLOW:
                # samples were dropped by the driver, so the device is
                # streaming: the receiver's lock-loss FSM re-syncs.  Keep
                # reading, but a device that only overflows is stalled
                timeouts = 0
                overflows += 1
                if overflows > self.READ_RETRIES:
                    raise RuntimeError(
                        f"SoapySDR readStream stalled ({overflows} "
                        f"consecutive OVERFLOW returns)")
                continue
            overflows = 0
            if got == SOAPY_SDR_TIMEOUT:
                timeouts += 1
                if timeouts < self.READ_RETRIES:
                    continue
                # persistently silent device: report end-of-stream
                return np.zeros((0,), np.complex64)
            raise RuntimeError(
                f"SoapySDR readStream error "
                f"{_ERR_NAMES.get(got, got)} ({got})")

    # consecutive recoverable-code retries before declaring the TX stream
    # wedged (1 s timeout each) — an unbounded retry would hang forever
    # on an unplugged/stalled device
    WRITE_RETRIES = 8

    def write(self, samples: np.ndarray) -> None:
        s = np.ascontiguousarray(samples, np.complex64)
        pos = 0
        stalls = 0
        while pos < len(s):
            chunk = s[pos:]
            ptrs = (ctypes.c_void_p * 1)(chunk.ctypes.data)
            sent = self._lib.SoapySDRDevice_writeStream(
                self._dev, self._stream, ptrs, len(chunk),
                ctypes.byref(self._flags), 0, 1_000_000)
            if sent in (SOAPY_SDR_TIMEOUT, SOAPY_SDR_UNDERFLOW):
                stalls += 1
                if stalls >= self.WRITE_RETRIES:
                    raise RuntimeError(
                        f"SoapySDR writeStream stalled "
                        f"({stalls} consecutive "
                        f"{_ERR_NAMES.get(sent, sent)} returns)")
                continue  # recoverable: retry the same chunk
            if sent <= 0:
                raise RuntimeError(
                    f"SoapySDR writeStream error "
                    f"{_ERR_NAMES.get(sent, sent)} ({sent})")
            stalls = 0
            pos += sent

    def close(self) -> None:
        L = self._lib
        L.SoapySDRDevice_deactivateStream(self._dev, self._stream, 0, 0)
        L.SoapySDRDevice_closeStream(self._dev, self._stream)
        L.SoapySDRDevice_unmake(self._dev)


class SoapySource:
    """`SampleSource` over a SoapySDR RX stream (or any injected device)."""

    def __init__(self, spec_or_args, device=None):
        args = (parse_spec(spec_or_args) if isinstance(spec_or_args, str)
                else dict(spec_or_args))
        self.args = args
        self._dev = device or _CtypesDevice(args, SOAPY_SDR_RX)

    def read(self, n: int) -> np.ndarray:
        return self._dev.read(n)

    def close(self) -> None:
        self._dev.close()


class SoapySink:
    """`SampleSink` over a SoapySDR TX stream (or any injected device)."""

    def __init__(self, spec_or_args, device=None):
        args = (parse_spec(spec_or_args) if isinstance(spec_or_args, str)
                else dict(spec_or_args))
        self.args = args
        self._dev = device or _CtypesDevice(args, SOAPY_SDR_TX)

    def write(self, samples: np.ndarray) -> None:
        self._dev.write(samples)

    def close(self) -> None:
        self._dev.close()
