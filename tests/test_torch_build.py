"""The C interface of the port's CUDA library, checked on the CPU.

The kernels are built and called only on the card, where a ctypes
signature that disagrees with the C function passes wrong arguments
without an error.  These tests parse ``dvbt_tpu_torch/csrc/*.cu`` and hold
every ``extern "C"`` entry point against ``kernels/_build.py``'s table, K2's
per-rate template table against ``utils/puncture.pattern``, the halo
ring's watchdog against fake events, and its choice of how to wait."""

import ctypes
import re
import threading
import time

import pytest

from dvbt_tpu_torch.kernels import _build
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
