"""Command-line apps of the port, run as ``python3 -m
dvbt_tpu_torch.apps.<name>``: tx (TS file -> IQ file or SDR sink), rx (IQ
file or SDR source -> TS file, with full acquisition), loopback (TX ->
impaired channel -> RX, a JSON report) and ber_sweep (BER / PER against
SNR over TX -> channel -> RX).  Counterparts of dvbt_tpu/apps; they run
on the card unless asked for the CPU (``--device cpu``).
"""
