"""The port's CLI apps (apps/{tx,rx,loopback}.py) and sample sources
(io/source.py, io/soapy.py) on the CPU, as tests/test_apps.py holds the
JAX package's: the tx -> rx round trip through files gives the TS the JAX
apps give on the same input; the SDR URL grammar, scheme dispatch, a
mock SoapySDR device end to end through the StreamingReceiver, the array
source, and the read/write retry rules, with the port's repair of read:
an OVERFLOW resets the TIMEOUT count and a run of OVERFLOWs raises."""

import ctypes
import json

import numpy as np
import pytest
import torch

from dvbt_tpu.apps import rx as j_rx_app
from dvbt_tpu.apps import tx as j_tx_app
from dvbt_tpu_torch import MODE_2K_QPSK
from dvbt_tpu_torch.apps import loopback as loopback_app
from dvbt_tpu_torch.apps import rx as rx_app
from dvbt_tpu_torch.apps import tx as tx_app
from dvbt_tpu_torch.io import soapy, source
from dvbt_tpu_torch.io import ts as tsio
from dvbt_tpu_torch.models import tx as txm
from dvbt_tpu_torch.models.loopback import StreamingReceiver

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_tx_rx_cli_roundtrip_matches_the_jax_apps(tmp_path):
    ts_in = tmp_path / "in.ts"
    n_blocks = 4
    _, n_pk, _ = txm.make_transmitter(MODE_2K_QPSK, CPU)
    pk = tsio.make_ts_packets(n_pk * n_blocks, seed=9)
    tsio.write_ts_file(str(ts_in), pk)

    iq, ts_out = tmp_path / "air.iq", tmp_path / "out.ts"
    assert tx_app.main(["--in", str(ts_in), "--out", str(iq),
                        "--device", "cpu"]) == 0
    assert rx_app.main(["--in", str(iq), "--out", str(ts_out),
                        "--device", "cpu"]) == 0
    got = tsio.read_ts_file(str(ts_out))
    # the receiver locks on the first frame boundary (block b0); the 11
    # deinterleaver-fill packets are dropped by read_ts_file's sync
    # search, and the last 11 input packets are still in the deinterleaver
    b0 = (len(pk) - len(got) - 11) // n_pk
    assert len(got) > n_pk
    assert np.array_equal(got, pk[b0 * n_pk:][: len(got)])

    j_iq, j_out = tmp_path / "jax.iq", tmp_path / "jax.ts"
    assert j_tx_app.main(["--in", str(ts_in), "--out", str(j_iq)]) == 0
    assert j_rx_app.main(["--in", str(j_iq), "--out", str(j_out)]) == 0
    assert ts_out.read_bytes() == j_out.read_bytes()
    np.testing.assert_allclose(np.fromfile(iq, np.complex64),
                               np.fromfile(j_iq, np.complex64),
                               rtol=0, atol=2e-5)


def test_loopback_app_reports_a_clean_run(capsys):
    assert loopback_app.main(["--blocks", "4", "--cfo", "0.3", "--offset",
                              "1000", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mode"] == "2k_qpsk_1/2_gi1/32"
    assert rep["byte_errors"] == 0 and rep["bytes_compared"] > 0
    assert rep["blocks_rx"] >= 2 and rep["rs_uncorrectable"] == 11


@pytest.mark.parametrize("app", [tx_app, rx_app, loopback_app])
def test_apps_without_a_card_exit_nonzero(monkeypatch, tmp_path, app):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {tx_app: ["--out", str(tmp_path / "x.iq")],
            rx_app: ["--in", str(tmp_path / "x.iq"), "--out",
                     str(tmp_path / "x.ts")],
            loopback_app: []}[app]
    with pytest.raises(SystemExit) as e:
        app.main(args)
    assert "no CUDA device" in str(e.value.code)


def test_sdr_schemes_dispatch_to_soapy():
    # without libSoapySDR.so the binding fails with install guidance
    with pytest.raises(RuntimeError, match="SoapySDR"):
        source.open_source("usrp://serial=X")
    with pytest.raises(RuntimeError, match="SoapySDR"):
        source.open_sink("rtlsdr://0")
    assert isinstance(source.open_sink("/dev/null"), source.FileSink)


def test_soapy_url_grammar():
    a = soapy.parse_spec("usrp://serial=ABC,freq=506e6,gain=30")
    assert a["driver"] == "uhd" and a["serial"] == "ABC"
    assert float(a["freq"]) == 506e6 and float(a["gain"]) == 30
    assert abs(float(a["rate"]) - 64e6 / 7) < 1e-3   # DVB-T default rate
    b = soapy.parse_spec("rtlsdr://freq=506e6")
    assert b["driver"] == "rtlsdr"
    c = soapy.parse_spec("soapy://driver=lime,rate=8e6")
    assert c["driver"] == "lime" and float(c["rate"]) == 8e6


def test_soapy_mock_device_end_to_end():
    """A mock SoapySDR device streaming a TX waveform through SoapySource
    -> StreamingReceiver decodes byte-exact."""
    mode = MODE_2K_QPSK
    tx, n_pk, _ = txm.make_transmitter(mode, CPU)
    pk = tsio.make_ts_packets(n_pk * 6, seed=2)
    tst = txm.init_tx_state(mode, 1, CPU)
    chunks = []
    for b in range(6):
        tst, iq = tx(tst, torch.from_numpy(pk[b * n_pk:(b + 1) * n_pk])[None])
        chunks.append(iq[0].numpy())
    stream = np.concatenate(chunks)

    class MockDevice:
        def __init__(self, s):
            self._s, self._pos = s, 0
            self.closed = False

        def read(self, n):
            out = self._s[self._pos:self._pos + n]
            self._pos += len(out)
            return out

        def close(self):
            self.closed = True

    dev = MockDevice(stream)
    src = soapy.SoapySource("rtlsdr://freq=506e6", device=dev)
    srx = StreamingReceiver(mode, CPU)
    reports = []
    while True:
        s = src.read(100_000)   # ragged live-style chunks
        if not len(s):
            break
        reports += srx.feed(s)
    src.close()
    assert dev.closed
    out = np.concatenate([r.packets for r in reports])
    b0 = round((reports[0].stream_offset + 8) / srx.block_samples)
    want, got = pk[b0 * n_pk:], out[11:]
    n = min(len(got), len(want))
    assert n > n_pk
    assert np.array_equal(got[:n], want[:n])


def test_array_source_and_sink_protocols():
    s = source.ArraySource(np.arange(10).astype(np.complex64))
    assert isinstance(s, source.SampleSource)
    assert len(s.read(4)) == 4
    assert len(s.read(100)) == 6
    assert len(s.read(1)) == 0
    sink = source.ArraySink()
    assert isinstance(sink, source.SampleSink)
    sink.write(np.ones(3))
    sink.write(np.zeros(2))
    assert np.array_equal(sink.samples(), [1, 1, 1, 0, 0])


class _FakeLib:
    def __init__(self, returns):
        self.returns = list(returns)
        self.calls = 0

    def SoapySDRDevice_readStream(self, dev, stream, ptrs, n, flags, time,
                                  timeout):
        self.calls += 1
        return self.returns.pop(0)

    def SoapySDRDevice_writeStream(self, dev, stream, ptrs, n, flags,
                                   time_ns, timeout):
        self.calls += 1
        return self.returns.pop(0)


def _device(returns):
    d = soapy._CtypesDevice.__new__(soapy._CtypesDevice)
    d._lib = _FakeLib(returns)
    d._dev = d._stream = None
    d._flags = ctypes.c_int(0)
    d._time = ctypes.c_longlong(0)
    return d


def test_soapy_read_retries_recoverable_codes():
    """TIMEOUT and OVERFLOW are retried instead of ending the stream; a
    fatal code raises with its name."""
    dev = _device([soapy.SOAPY_SDR_OVERFLOW, soapy.SOAPY_SDR_TIMEOUT, 7])
    assert len(dev.read(16)) == 7
    assert dev._lib.calls == 3
    # persistent timeouts: bounded retries, then end of stream
    dev = _device([soapy.SOAPY_SDR_TIMEOUT] * soapy._CtypesDevice.READ_RETRIES)
    assert len(dev.read(16)) == 0
    assert dev._lib.calls == soapy._CtypesDevice.READ_RETRIES
    dev = _device([-2])
    with pytest.raises(RuntimeError, match="STREAM_ERROR"):
        dev.read(16)


def test_soapy_read_overflow_resets_timeouts_and_a_run_raises():
    """The port's repair: an OVERFLOW (the device is streaming) resets the
    count of consecutive TIMEOUTs, and more than READ_RETRIES consecutive
    OVERFLOWs raise instead of retrying forever."""
    k = soapy._CtypesDevice.READ_RETRIES
    T, O = soapy.SOAPY_SDR_TIMEOUT, soapy.SOAPY_SDR_OVERFLOW
    # k - 1 timeouts, an overflow, k - 1 timeouts: data still arrives (the
    # original counted 2k - 2 timeouts and reported end of stream)
    dev = _device([T] * (k - 1) + [O] + [T] * (k - 1) + [5])
    assert len(dev.read(16)) == 5
    assert dev._lib.calls == 2 * k
    # k consecutive overflows are still retried
    dev = _device([O] * k + [3])
    assert len(dev.read(16)) == 3
    # a timeout breaks a run of overflows
    dev = _device([O] * k + [T] + [O] * k + [4])
    assert len(dev.read(16)) == 4
    # k + 1 consecutive overflows: the stream is stalled
    dev = _device([O] * (k + 1) + [9])
    with pytest.raises(RuntimeError, match="readStream stalled"):
        dev.read(16)
    assert dev._lib.calls == k + 1


def test_soapy_write_retries_and_stall_bound():
    samples = np.zeros(16, np.complex64)
    # timeout, partial write (10), underflow, rest (6): completes
    dev = _device([soapy.SOAPY_SDR_TIMEOUT, 10, soapy.SOAPY_SDR_UNDERFLOW, 6])
    dev.write(samples)
    assert dev._lib.calls == 4
    dev = _device([soapy.SOAPY_SDR_TIMEOUT] *
                  soapy._CtypesDevice.WRITE_RETRIES)
    with pytest.raises(RuntimeError, match="stalled"):
        dev.write(samples)
    dev = _device([-3])
    with pytest.raises(RuntimeError, match="CORRUPTION"):
        dev.write(samples)
