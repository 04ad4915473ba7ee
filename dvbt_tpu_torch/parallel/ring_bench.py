"""K4 (the halo ring) on the card: check it against its plain version and
time it, in every rank of a process group.

    python3 -m dvbt_tpu_torch.parallel.ring_bench [--ranks N]

starts N rank processes (default: one per card when the host has two or
more, else 4 on the one card), checks K4 byte for byte against the plain
send/recv version on the JAX test's payloads and the flagship's two halos
and that lone calls time out and raise, on each of its two routes (waits
in stream order, waits on the SMs) whatever the layout would choose, runs
the parallel dryrun at MODE_8K_UK and its soft-demap and hierarchical
variants (those on each route), times K4, the plain version and, where
every rank has a card of its own, NCCL send/recv (``dist.batch_isend_irecv``
over an NCCL group, the library call for the same function), and times the
time-sharded step with either halo on the host clock.
Prints one JSON line.  ``chip_smoke.py`` runs ``rank_main`` in its phase
7, with 4 ranks on its one card.  On one card the ranks' contexts are
time-sliced, so K4's time there includes its neighbour barrier across
them.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..io.ts import make_ts_packets
from ..kernels import _build
from ..mode import MODE_8K_UK, DvbtMode
from . import multihost, ring
from . import time_sharding as tsh


# the hierarchical configuration the card checks: 8K 64-QAM alpha=2, HP at
# the flagship's rate 2/3, LP 3/4 (the JAX package's 8K hierarchical test)
HIER_8K = DvbtMode("8k", "64qam", "2/3", "1/32", alpha=2, code_rate_lp="3/4")


def halo_payloads() -> dict:
    """The flagship's two halos (name -> numpy array, from a seed): the TX
    packet halo and the RX sample halo of MODE_8K_UK."""
    rng = np.random.default_rng(1)
    n = tsh.rx_halo_symbols(MODE_8K_UK) * MODE_8K_UK.symbol_len
    return {
        "pk": rng.integers(0, 256, (tsh.HALO_PACKETS, 188)).astype(np.uint8),
        "iq": (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64),
    }


def _plus(x: np.ndarray, k: int) -> np.ndarray:
    """x + k, wrapping for uint8 (each rank sends its own payload)."""
    if x.dtype == np.uint8:
        return ((x.astype(np.int32) + k) % 256).astype(np.uint8)
    return x + np.asarray(k, x.dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


@contextlib.contextmanager
def waiting(on_sms: bool):
    """Rings set up inside wait on the SMs (one kernel) or in
    stream order, whichever layout the ranks' cards have: a check of the
    route the layout would not choose."""
    chooses = ring.cards_apart
    ring.cards_apart = lambda cards: on_sms
    try:
        yield
    finally:
        ring.cards_apart = chooses


def _waits(shift: ring.RingShift) -> str:
    return "on the SMs" if shift.on_sms else "in stream order"


def check_ring(payloads: dict, device) -> tuple[float, str]:
    """K4 against its plain version on every payload, 4 calls of one ring
    object each (each rank sends payload + rank + 10 * call);
    raises on any byte that differs from the plain version or from the
    left neighbour's payload.  Returns the largest |difference| (0) and
    how the calls waited."""
    rank, D = dist.get_rank(), dist.get_world_size()
    err = 0.0
    for name, x in payloads.items():
        shift = ring.make_ring_shift()
        for call in range(4):
            mine = torch.as_tensor(_plus(x, rank + 10 * call), device=device)
            got = shift(mine)
            want = ring.ring_shift_plain(mine)
            shift.check()
            left = torch.as_tensor(_plus(x, (rank - 1) % D + 10 * call),
                                   device=device)
            err = max(err, float((got.to(torch.complex128)
                                  - want.to(torch.complex128)).abs().max()))
            if not (got.dtype == want.dtype and got.shape == want.shape
                    and torch.equal(_bytes(got), _bytes(want))
                    and torch.equal(_bytes(got), _bytes(left))):
                raise AssertionError(f"rank {rank}: K4 ({_waits(shift)}) "
                                     f"differs from its plain version on "
                                     f"{name}, call {call}")
        waits = _waits(shift)
        shift.close()
    return err, waits


def check_timeout(device, timeout_s: float = 2.0) -> list[str]:
    """Two calls that only the last rank makes (with a card per rank, not
    on card 0) must each time out (after ``timeout_s``) and raise, not
    hang, within ``timeout_s`` + 1 s: one caller calls ``check()`` at once,
    the other first synchronises the stream itself.  Returns, on every
    rank, the errors they raised."""
    rank, D = dist.get_rank(), dist.get_world_size()
    x = torch.zeros(16, dtype=torch.uint8, device=device)
    msgs = []
    for sync_first in (False, True):
        shift = ring.make_ring_shift(timeout_s=timeout_s)
        shift(x)                   # every rank: set-up and one real call
        shift.check()
        dist.barrier()
        if rank == D - 1:
            t0 = time.perf_counter()
            shift(x)               # alone: no neighbour enters this call
            msg = ""
            try:
                if sync_first:
                    torch.cuda.current_stream(device).synchronize()
                shift.check()
            except RuntimeError as e:
                msg = str(e)
            took = time.perf_counter() - t0
            if "timed out" not in msg:
                raise AssertionError("a lone K4 call did not time out")
            if took > timeout_s + 1:
                raise AssertionError(f"a lone K4 call raised after {took:.2f}"
                                     f" s, past {timeout_s} s + 1 s")
            msgs.append(f"{msg} (raised after {took:.3f} s, waited "
                        f"{_waits(shift)} on {device}"
                        f"{', stream synchronised first' if sync_first else ''})")
        shift.close()
    msgs = [msgs]
    dist.broadcast_object_list(msgs, D - 1)
    return msgs[0]


def _event_ms(fn, reps: int) -> float:
    """Mean time of fn() over reps calls by CUDA events, every rank
    starting together."""
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ring(payloads: dict, device, nccl=None) -> dict:
    """Per payload: K4, the plain version and (with an NCCL group) NCCL
    send/recv, ms per call by CUDA events in the order plain, K4, K4,
    plain, then the library call twice; and how K4's calls waited."""
    rank, D = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, x in payloads.items():
        xt = torch.as_tensor(x, device=device)
        shift = ring.make_ring_shift()
        recv = torch.empty_like(xt)

        def k4():
            shift(xt)

        def plain():
            ring.ring_shift_plain(xt)

        def library():
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, xt, (rank + 1) % D, nccl),
                    dist.P2POp(dist.irecv, recv, (rank - 1) % D, nccl)]):
                req.wait()

        runs = {"plain": [_event_ms(plain, 10)],
                "k4": [_event_ms(k4, 50), _event_ms(k4, 50)]}
        runs["plain"].append(_event_ms(plain, 10))
        shift.check()
        waits = _waits(shift)
        shift.close()
        if nccl is not None:
            runs["library"] = [_event_ms(library, 50), _event_ms(library, 50)]
        out[name] = {"bytes": int(x.nbytes), "waits": waits, "runs": runs,
                     **{k: sum(v) / len(v) for k, v in runs.items()}}
    return out


def time_steps(mode, device, n_rounds: int = 8) -> dict:
    """Host-clock ms per time-sharded step with each halo path: both
    loopbacks are built first and warmed up by one step, then n_rounds
    rounds each time one step of each, in the order send/recv, K4, K4,
    send/recv, ... (every rank starting each step together; every step
    ends in collectives and a synchronise).  Returns each path's median
    and its steps."""
    rank, D = dist.get_rank(), dist.get_world_size()
    n_steps = n_rounds + 1
    packets = make_ts_packets(mode.packets_per_block * D * n_steps, seed=21)
    loops = {halo: tsh.make_time_sharded_loopback(mode, device, halo=halo)
             for halo in ("ppermute", "ring")}
    carries = {halo: loop[2] for halo, loop in loops.items()}
    times = {halo: [] for halo in loops}

    def run(halo: str, s: int) -> float:
        step, n_pk = loops[halo][:2]
        b = s * D + rank
        x = torch.as_tensor(packets[b * n_pk:(b + 1) * n_pk], device=device)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        carries[halo] = step(carries[halo], x)[0]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for halo in loops:
        run(halo, 0)
    for s in range(1, n_steps):
        order = ("ppermute", "ring") if s % 2 else ("ring", "ppermute")
        for halo in order:
            times[halo].append(run(halo, s))
    for loop in loops.values():
        loop[3]()                  # close
    return {**{k: float(np.median(v)) for k, v in times.items()},
            "steps": times}


def jax_test_payloads() -> dict:
    """The three payloads of the JAX package's ring test
    (tests/test_time_sharding.py), from a seed."""
    rng = np.random.default_rng(0)
    return {
        "uint8 (12, 188)": rng.integers(0, 256, (12, 188)).astype(np.uint8),
        "complex64 (257,)": (rng.normal(size=257) + 1j * rng.normal(
            size=257)).astype(np.complex64),
        "float32 (64, 8)": rng.normal(size=(64, 8)).astype(np.float32),
    }


# the dryrun's variants beside the flagship's hard one: (name, mode, demap)
VARIANTS = (("soft", MODE_8K_UK, "soft"),
            ("hierarchical", HIER_8K, "hard"))


def _counted(fn) -> tuple:
    """(fn(), each kernel's launches during it summed over the ranks): the
    differences of ``_build.launches`` across fn(), gathered."""
    torch.cuda.synchronize()
    before = _build.launches.copy()
    out = fn()
    torch.cuda.synchronize()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, dict(_build.launches - before))
    return out, dict(sum(map(collections.Counter, ranks),
                         collections.Counter()))


def rank_main(rank: int, n_ranks: int, out_path: str) -> None:
    """One rank: K4 against its plain version on the JAX test's payloads
    and the flagship's halos and lone calls that must time out, on either
    route, the dryrun at MODE_8K_UK with each kernel's launches during
    it summed over the ranks (``_counted``), the soft and the
    hierarchical dryruns on each of K4's routes (counted the same way),
    then the K4 and step timings.  Rank 0 writes the results as
    JSON to ``out_path``."""
    from . import sharding

    device = multihost.rank_device(rank)
    torch.cuda.set_device(device)
    own_cards = torch.cuda.device_count() >= n_ranks
    nccl = dist.new_group(backend="nccl") if own_cards else None
    halos = halo_payloads()
    payloads = {**jax_test_payloads(),
                **{f"{k} halo {v.dtype} {v.shape}": v
                   for k, v in halos.items()}}
    routes = []
    for on_sms in (False, True):
        with waiting(on_sms):
            err, waits = check_ring(payloads, device)
            routes.append({"waits": waits, "k4_err": err,
                           "timeout_error": check_timeout(device)})
    dry, launches = _counted(lambda: sharding.dryrun(
        MODE_8K_UK, n_ranks, muxes_per_rank=2))
    runs = []
    for name, mode, demap in VARIANTS:
        for on_sms in (False, True):
            with waiting(on_sms):
                out, counts = _counted(lambda: sharding.dryrun(
                    mode, n_ranks, muxes_per_rank=2, demap=demap))
            runs.append({"name": name, "demap": demap,
                         "waits": "on the SMs" if on_sms
                         else "in stream order",
                         "dryrun": out, "launches": counts})
    res = {"ranks": n_ranks, "card_per_rank": own_cards,
           "k4_err": max(r["k4_err"] for r in routes),
           "payloads": list(payloads), "routes": routes,
           "launches": launches, "variants": runs,
           "dryrun": dry, "times": time_ring(halos, device, nccl),
           "step_ms": time_steps(MODE_8K_UK, device)}
    if rank == 0:
        Path(out_path).write_text(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes (default: one per card when there "
                         "are 2 or more, else 4 on the one card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ring_bench: no CUDA device")
    n_cards = torch.cuda.device_count()
    n_ranks = args.ranks or (n_cards if n_cards >= 2 else 4)
    _build.library()
    out_path = _build.BUILD_DIR / f"ring_bench_{os.getpid()}.json"
    multihost.launch(rank_main, n_ranks, args=(str(out_path),),
                     timeout_s=300, deadline_s=900)
    res = json.loads(out_path.read_text())
    res["device"] = {"kind": torch.cuda.get_device_name(0),
                     "count": n_cards}
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
