"""Parallel paths over ranks: one process per rank, ``torch.distributed``
between them (the JAX package's ``dvbt_tpu/parallel``).

  multihost.py     — rank bootstrap, process launch, host-staged collectives
  ring.py          — the halo ring: kernel K4 (CUDA IPC) and its plain
                     send/recv version
  time_sharding.py — one stream's blocks over ranks, state from halos
  sharding.py      — mux-DP over ranks, and the three-stage dryrun
"""
