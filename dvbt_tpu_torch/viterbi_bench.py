"""Device time of the two Viterbi kernels at the main path's shapes.

    python3 -m dvbt_tpu_torch.viterbi_bench

K1 (``viterbi_punct``) at the flagship RX's shape: 8 muxes x 9,870,336
coded values at rate 2/3, body 1024 and the effective overlap.  K3
(``viterbi_depunct``) at the block path's: 8 x 6,580,224 steps,
``auto_body`` and overlap 128; and at the time-sharded halo recompute's:
1 x 24,192 steps, body 1024.  The inputs are the noiseless code of random
bits (the kernels' time does not depend on the values).  Each kernel is
timed by CUDA events over back-to-back launches, in the order K1, K3, K3
halo, K3 halo, K3, K1, and each time is printed with the card's name and
power limit.  It uses only the kernels' public wrappers, so the same file
times any tree of the package that has them.  ``chip_smoke.py`` takes its
timer and inputs from here.
"""

from __future__ import annotations

import dataclasses

import torch

from . import MODE_8K_UK
from .apps.device import card as device_card
from .kernels import coder as kcoder
from .kernels import viterbi as kvit
from .ops import inner_coder
from .ops import viterbi as vops
from .parallel import time_sharding

MODE = MODE_8K_UK
N_MUX = 8
FLAG_BITS = MODE.packets_per_block * 4 * 204 * 8     # 4 frames a mux
HALO_BITS = ((time_sharding.rx_halo_symbols(MODE) - time_sharding.CHAN_WARMUP)
             * int(MODE.stream_info_bits_per_symbol("hp")))
HALO_BODY = 1024


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass(frozen=True)
class Inputs:
    """K1's and K3's inputs for n_mux streams of random info bits, coded at
    the flagship rate without noise (soft values 0/15) and decoded from a
    zero tail: K1 takes the punctured stream at body 1024 and the effective
    overlap, K3 its depunctured steps at ``k3_body`` and overlap 128."""
    info: torch.Tensor        # (n_mux, n_bits // 8) uint8: the sent bytes
    coded: torch.Tensor       # (n_mux, n_c) uint8 0/15
    k1_tail: torch.Tensor     # (n_mux, 4, effective overlap)
    k3_steps: tuple           # x, y, xm, ym (n_mux, n_bits) uint8
    k3_tail: torch.Tensor     # (n_mux, 4, 128)
    k3_body: int
    rate: str = MODE.code_rate
    k1_body: int = vops.DEFAULT_BODY

    @property
    def n_bits(self) -> int:
        return self.k3_steps[0].shape[-1]

    def k1(self) -> torch.Tensor:
        return kvit.viterbi_punct(self.coded, self.k1_tail, self.n_bits,
                                  self.rate, self.k1_body)

    def k1_plain(self) -> torch.Tensor:
        return kvit.viterbi_punct_plain(self.coded, self.k1_tail,
                                        self.n_bits, self.rate, self.k1_body)

    def k3(self) -> torch.Tensor:
        return kvit.viterbi_depunct(*self.k3_steps, self.k3_tail,
                                    self.k3_body)

    def k3_plain(self) -> torch.Tensor:
        return kvit.viterbi_depunct_plain(*self.k3_steps, self.k3_tail,
                                          self.k3_body)


def make_inputs(dev, n_mux: int, n_bits: int, k3_body: int,
                seed: int) -> Inputs:
    gen = torch.Generator(device=dev).manual_seed(seed)
    rate = MODE.code_rate
    info = torch.randint(0, 256, (n_mux, n_bits // 8), generator=gen,
                         dtype=torch.uint8, device=dev)
    state0 = torch.zeros(n_mux, 6, dtype=torch.uint8, device=dev)
    _, coded = kcoder.byte_coder(state0, info, rate)
    coded = (coded * 15).contiguous()
    ov = vops.effective_overlap(rate)
    steps = tuple(s.contiguous() for s in
                  inner_coder.make_depuncture(n_bits, rate)(coded))
    return Inputs(
        info=info, coded=coded,
        k1_tail=torch.zeros(n_mux, 4, ov, dtype=torch.uint8, device=dev),
        k3_steps=steps,
        k3_tail=torch.zeros(n_mux, 4, kvit.DEFAULT_OVERLAP,
                            dtype=torch.uint8, device=dev),
        k3_body=k3_body)


def main_path_inputs(dev, seed: int = 5) -> Inputs:
    """The flagship RX's shape for K1, the block path's for K3."""
    return make_inputs(dev, N_MUX, FLAG_BITS, kvit.auto_body(FLAG_BITS),
                       seed)


def halo_inputs(dev, seed: int = 6) -> Inputs:
    """The time-sharded halo recompute's shape for K3."""
    return make_inputs(dev, 1, HALO_BITS, HALO_BODY, seed)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("viterbi_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = device_card(dev)
    main_in, halo_in = main_path_inputs(dev), halo_inputs(dev)
    runs = {"K1": (main_in.k1, 10), "K3": (main_in.k3, 10),
            "K3 halo": (halo_in.k3, 200)}
    times = {name: [] for name in runs}
    for name in ("K1", "K3", "K3 halo", "K3 halo", "K3", "K1"):
        fn, reps = runs[name]
        times[name].append(event_ms(fn, reps))

    def fmt(name):
        return ", ".join(f"{t:.4f}" for t in times[name])

    ov = vops.effective_overlap(main_in.rate)
    print(f"K1 viterbi_punct {N_MUX} x {main_in.coded.shape[-1]} coded "
          f"values, body {main_in.k1_body}, overlap {ov}: {fmt('K1')} ms "
          f"({card})")
    print(f"K3 viterbi_depunct {N_MUX} x {FLAG_BITS} steps, body "
          f"{main_in.k3_body}, overlap {kvit.DEFAULT_OVERLAP}: {fmt('K3')} "
          f"ms ({card})")
    print(f"K3 halo viterbi_depunct 1 x {HALO_BITS} steps, body "
          f"{HALO_BODY}, overlap {kvit.DEFAULT_OVERLAP}: {fmt('K3 halo')} "
          f"ms ({card})")


if __name__ == "__main__":
    main()
