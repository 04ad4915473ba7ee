"""The C interface of the port's CUDA library, checked on the CPU.

The kernels are built and called only on the card, where a ctypes
signature that disagrees with the C function passes wrong arguments
without an error.  These tests parse ``dvbt_tpu_torch/csrc/*.cu`` and hold
every ``extern "C"`` entry point against ``kernels/_build.py``'s table, K2's
per-rate template table against ``utils/puncture.pattern``, the halo
ring's watchdog against fake events, and its choice of how to wait.  The
port's one launch count, ``_build.launches``, is the only one any module
keeps, and a wrapper given CPU tensors runs its plain version and counts
no launch."""

import collections
import ctypes
import importlib
import pkgutil
import re
import threading
import time

import numpy as np
import pytest
import torch

import dvbt_tpu_torch
from dvbt_tpu_torch.kernels import _build
from dvbt_tpu_torch.kernels import acquire as kacquire
from dvbt_tpu_torch.kernels import coder as kcoder
from dvbt_tpu_torch.kernels import demap as kdemap
from dvbt_tpu_torch.kernels import rs as krs
from dvbt_tpu_torch.kernels import viterbi as kvit
from dvbt_tpu_torch.mode import DvbtMode
from dvbt_tpu_torch.parallel import ring
from dvbt_tpu_torch.utils import puncture

RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")
_ENTRY = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(dvbt_\w+)\s*\(([^)]*)\)')


def _c_type(param: str):
    """The ctypes type that passes one C parameter unchanged."""
    decl = re.sub(r"\b(const|volatile)\b", "", param)
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()
    return {"int64_t": ctypes.c_int64, "int": ctypes.c_int}[words[0]]


def entry_points() -> dict:
    """name -> (return type text, [ctypes type of each parameter])."""
    found = {}
    for src in _build.sources():
        for ret, name, params in _ENTRY.findall(src.read_text()):
            params = [p for p in params.split(",") if p.strip()]
            assert name not in found, f"{name} defined twice"
            found[name] = (" ".join(ret.split()), [_c_type(p) for p in params])
    return found


def test_every_entry_point_has_a_matching_signature():
    found = entry_points()
    assert set(found) == set(_build._SIGNATURES), (
        "C entry points without a ctypes signature: "
        f"{sorted(set(found) - set(_build._SIGNATURES))}; signatures "
        f"without an entry point: {sorted(set(_build._SIGNATURES) - set(found))}")
    for name, (ret, params) in found.items():
        assert _build._SIGNATURES[name] == params, name
        want = _build._RESTYPES.get(name, ctypes.c_int)
        assert {"int": ctypes.c_int, "const char*": ctypes.c_char_p,
                "const char *": ctypes.c_char_p}[ret] is want, name


@pytest.mark.parametrize("rate", RATES)
def test_coder_template_table_matches_puncture(rate):
    """K2 has one instantiation a rate; its (period, keep, order) must be
    the Table-3 pattern the wrapper passes, or the launch is refused."""
    src = (_build.CSRC / "coder.cu").read_text()
    table = {(int(p), int(k)): int(o, 16) for p, k, o in re.findall(
        r"X\((\d+), (\d+), (0x[0-9a-f]+)u\)", src)}
    assert len(table) == len(RATES)
    pat = puncture.pattern(rate)
    packed = sum(o << (4 * r) for r, o in enumerate(pat.order))
    assert table[(pat.period, pat.keep)] == packed


def _wrapper_case(kernel: str) -> tuple:
    """(wrapper, plain version, arguments on CPU tensors) of one kernel."""
    rng = np.random.default_rng(7)

    def u8(*shape, high=256):
        return torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint8))

    tail = torch.zeros(2, 4, 96, dtype=torch.uint8)
    if kernel == "byte_coder":
        return (kcoder.byte_coder, kcoder.byte_coder_plain,
                (torch.zeros(2, 6, dtype=torch.uint8), u8(2, 120), "3/4"))
    if kernel == "viterbi_punct":
        return (kvit.viterbi_punct, kvit.viterbi_punct_plain,
                (u8(2, 2048, high=16), tail, 1024, "1/2", 256))
    if kernel == "viterbi_depunct":
        return (kvit.viterbi_depunct, kvit.viterbi_depunct_plain,
                (u8(2, 1024, high=16), u8(2, 1024, high=16),
                 u8(2, 1024, high=2), u8(2, 1024, high=2), tail, 256))
    if kernel == "rs_decode":
        return krs.rs_decode, krs.make_rs_decoder_plain("cpu"), (u8(3, 204),)
    if kernel == "demap":
        mode = DvbtMode("2k", "64qam", "2/3", alpha=2, code_rate_lp="3/4")
        X, H = (torch.from_numpy(
            (rng.standard_normal((2, 4, mode.n_carriers, 2)) @ [1, 1j])
            .astype(np.complex64)) for _ in range(2))
        return (kdemap.make_demap_deinterleave(mode, "cpu", "soft"),
                kdemap.make_demap_deinterleave_plain(mode, "cpu", "soft"),
                (X, H))
    if kernel == "acquire":
        mode = DvbtMode("2k", "qpsk", "1/2", "1/8")
        n = 4 * mode.symbol_len + 5
        iq = torch.from_numpy((rng.standard_normal((3, n, 2)) @ [1, 1j])
                              .astype(np.complex64))
        return (kacquire.make_symbol_acquisition(mode, n),
                kacquire.make_symbol_acquisition_plain(mode, n), (iq,))
    return krs.rs_encode, krs.make_rs_encoder_plain("cpu"), (u8(3, 188),)


@pytest.mark.parametrize("kernel", ["byte_coder", "viterbi_punct",
                                    "viterbi_depunct", "rs_decode",
                                    "rs_encode", "demap", "acquire"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(kernel):
    wrapper, plain, args = _wrapper_case(kernel)
    before = _build.launches.copy()
    got, want = wrapper(*args), plain(*args)
    assert _build.launches == before
    got, want = ((o,) if torch.is_tensor(o) else o for o in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_only_build_keeps_a_launch_count():
    """Every wrapper counts its launches in ``_build.launches``: no other
    module of the port keeps a module-level count."""
    found = []
    for m in pkgutil.walk_packages(dvbt_tpu_torch.__path__,
                                   "dvbt_tpu_torch."):
        module = importlib.import_module(m.name)
        found += [f"{m.name}.{name}" for name, v in vars(module).items()
                  if "launches" in name.lower()
                  and isinstance(v, (int, collections.Counter))]
    assert found == ["dvbt_tpu_torch.kernels._build.launches"]


class _Event:
    """A stand-in for torch.cuda.Event: done once ``done`` is set."""

    def __init__(self, done=False):
        self.done = done

    def query(self):
        return self.done


def test_ring_watchdog_expires_a_stuck_call_and_passes_a_finished_one():
    fired = []
    dog = ring.Watchdog(0.05, lambda seq, code: fired.append((seq, code)))
    dog.watch(1, _Event(True), _Event(True), _Event(True))
    stuck = _Event()
    sent = _Event()
    dog.watch(2, _Event(True), sent, stuck)
    t0 = time.monotonic()
    while not fired and time.monotonic() - t0 < 5:
        time.sleep(0.005)
    assert fired[0] == (2, 1)              # stuck in the neighbour barrier
    sent.done = True
    while len(fired) < 2 and time.monotonic() - t0 < 5:
        time.sleep(0.005)
    assert fired[1] == (2, 2)              # again, now on the payload
    stuck.done = True
    closer = threading.Thread(target=dog.close)
    closer.start()
    closer.join(5)
    assert not closer.is_alive()


def test_ring_watchdog_starts_the_clock_when_the_call_begins():
    fired = []
    dog = ring.Watchdog(0.05, lambda seq, code: fired.append((seq, code)))
    begin, end = _Event(), _Event()
    dog.watch(1, begin, _Event(), end)
    time.sleep(0.2)
    assert not fired                       # queued behind other work
    end.done = begin.done = True
    dog.close()
    assert not fired


def test_ring_watchdog_keeps_a_failed_release_and_the_ring_raises_it():
    """An expire that raises stops the thread and is kept; the ring's
    check() and close() then raise it at once instead of waiting on a
    stream that may never drain."""
    def expire(seq, code):
        raise OSError("release refused")

    dog = ring.Watchdog(0.05, expire)
    dog.watch(1, _Event(True), _Event(), _Event())
    dog._thread.join(5)
    assert not dog._thread.is_alive()
    assert isinstance(dog.error, OSError)
    dog.close()                            # returns: the thread has ended
    shift = ring.RingShift()
    word = (ctypes.c_int * 2)()
    shift._base, shift._watchdog = 1, dog
    shift._err_host = ctypes.addressof(word)
    for call in (shift.check, shift.close):
        with pytest.raises(RuntimeError, match="watchdog failed") as info:
            call()
        assert isinstance(info.value.__cause__, OSError)


@pytest.mark.parametrize("cards, apart", [
    ("a", False),            # one rank
    ("aaaa", False),         # 4 ranks on one card
    ("aabb", False),         # neighbours 0-1 and 2-3 share a card
    ("abab", True),          # 2 cards, no neighbours on one card
    ("abcd", True),          # a card per rank
])
def test_ring_waits_on_the_sms_only_where_no_neighbours_share_a_card(
        cards, apart):
    assert ring.cards_apart([c.encode() for c in cards]) is apart
