"""Command-line apps of the port, run as ``python3 -m
dvbt_tpu_torch.apps.<name>``: ber_sweep (BER / PER against SNR over TX ->
channel -> RX).  Counterparts of dvbt_tpu/apps; they run on the card
unless asked for the CPU.
"""
