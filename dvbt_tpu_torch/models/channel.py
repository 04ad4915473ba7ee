"""Channel impairment models for loopback and BER runs.

Counterpart of dvbt_tpu/models/channel.py: AWGN, carrier frequency offset,
timing offset, sample-clock offset and static multipath, with the EN 300
744 Annex B propagation profiles F1 and P1.  Every function takes a
leading mux axis where the JAX package takes one stream; ``awgn`` measures
the signal power of each mux row, as ``jax.vmap`` of the JAX function
would.  None of these stages is a Pallas kernel in the JAX package, so
all are plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cplx import cis


def awgn(gen: torch.Generator, iq: torch.Tensor,
         snr_db: float) -> torch.Tensor:
    """Add complex AWGN at ``snr_db`` below each row's measured signal
    power.  ``gen`` is a ``torch.Generator`` on ``iq``'s device; its noise
    is not ``jax.random``'s, so runs compare by statistics."""
    p_sig = (iq.abs() ** 2).mean(-1, keepdim=True)
    sigma = torch.sqrt(p_sig / (10.0 ** (snr_db / 10.0)) / 2.0)
    re = torch.randn(iq.shape, generator=gen, dtype=torch.float32,
                     device=iq.device)
    im = torch.randn(iq.shape, generator=gen, dtype=torch.float32,
                     device=iq.device)
    return (iq + torch.complex(re, im) * sigma).to(torch.complex64)


def apply_cfo(iq: torch.Tensor, cfo_subcarriers: float, fft_len: int,
              phase0: float = 0.0) -> torch.Tensor:
    """Rotate by a carrier frequency offset given in subcarrier spacings."""
    n = torch.arange(iq.shape[-1], dtype=torch.float32, device=iq.device)
    rot = cis(2.0 * np.pi * cfo_subcarriers * n / fft_len + phase0)
    return (iq * rot).to(torch.complex64)


def apply_delay(iq: torch.Tensor, delay: int) -> torch.Tensor:
    """Prepend ``delay`` zero samples (timing offset), keeping length."""
    if delay == 0:
        return iq
    pad = iq.new_zeros(iq.shape[:-1] + (delay,))
    return torch.cat([pad, iq], dim=-1)[..., :iq.shape[-1]]


def resample_ppm(iq, ppm: float):
    """Sample-clock offset: resample by a factor (1 + ppm*1e-6).

    Host-side (numpy) linear interpolation — models a receiver ADC whose
    clock runs `ppm` parts-per-million FAST relative to the transmitter
    (ppm > 0 squeezes the waveform: each output sample advances less signal
    time, so symbol boundaries drift later in the sample stream).
    """
    import numpy as np
    x = np.asarray(iq, np.complex64)
    f = 1.0 + ppm * 1e-6
    n_out = int(np.floor((len(x) - 1) * f))
    pos = np.arange(n_out) / f          # signal time of each output sample
    t = np.arange(len(x))
    return (np.interp(pos, t, x.real) + 1j * np.interp(pos, t, x.imag)
            ).astype(np.complex64)


def multipath(iq: torch.Tensor, taps) -> torch.Tensor:
    """Static FIR multipath (taps complex, tap 0 = line of sight): the sum
    of each nonzero tap times the signal delayed by its index, in the JAX
    package's order (its zero taps add exact zeros)."""
    t = torch.as_tensor(taps).detach().to("cpu", torch.complex64)
    out = iq * complex(t[0])
    for d in torch.nonzero(t[1:]).reshape(-1).tolist():
        out = out + apply_delay(iq, d + 1) * complex(t[d + 1])
    return out.to(torch.complex64)


# --- EN 300 744 Annex B propagation profiles --------------------------------
# the JAX package's 20-echo ensemble (amplitude rho_i, phase theta_i rad,
# delay tau_i us), copied whole: F1 ("fixed reception", Ricean K = 10 dB,
# the echoes plus a direct ray) and P1 ("portable reception", Rayleigh,
# echoes only).  Delays are rounded to the sample grid.

_ANNEX_B_RHO = (
    0.057662, 0.176809, 0.407163, 0.303585, 0.258782,
    0.061831, 0.150340, 0.051534, 0.185074, 0.400967,
    0.295723, 0.350825, 0.262909, 0.225894, 0.170996,
    0.149723, 0.240140, 0.116587, 0.221155, 0.259730,
)
_ANNEX_B_THETA = (
    4.855121, 3.419109, 5.864470, 2.215894, 3.758058,
    5.430202, 3.952093, 1.093586, 5.775198, 0.154459,
    5.928383, 3.053023, 0.628578, 2.128544, 1.099463,
    3.462951, 3.664773, 2.833799, 3.334290, 0.393889,
)
_ANNEX_B_TAU_US = (
    1.003019, 5.422091, 0.518650, 2.751772, 0.602895,
    1.016585, 0.143556, 0.153832, 3.324866, 1.935570,
    0.429948, 3.228872, 0.848831, 0.073883, 0.203952,
    0.194207, 0.924450, 1.381320, 0.640512, 1.368671,
)


def annex_b_taps(profile: str, sample_rate_hz: float = 64e6 / 7
                 ) -> torch.Tensor:
    """Static FIR taps for the Annex B channel: "F1" (fixed / Ricean,
    K = 10 dB direct ray at delay 0) or "P1" (portable / Rayleigh, echoes
    only).  Returns a unit-power complex64 tap vector on the sample grid
    (on the CPU), consumable by :func:`multipath`."""
    if profile not in ("F1", "P1"):
        raise ValueError(f"profile={profile!r} is not 'F1' or 'P1'")
    rho = np.asarray(_ANNEX_B_RHO)
    theta = np.asarray(_ANNEX_B_THETA)
    d = np.round(np.asarray(_ANNEX_B_TAU_US) * 1e-6 * sample_rate_hz
                 ).astype(np.int64)
    taps = np.zeros(int(d.max()) + 1, np.complex128)
    np.add.at(taps, d, rho * np.exp(-1j * theta))
    if profile == "F1":
        # Ricean factor K = 10 dB: direct-ray power = 10 * echo power
        taps[0] += np.sqrt(10.0 * np.sum(rho ** 2))
    taps /= np.sqrt(np.sum(np.abs(taps) ** 2))
    return torch.complex(torch.from_numpy(taps.real.astype(np.float32)),
                         torch.from_numpy(taps.imag.astype(np.float32)))
