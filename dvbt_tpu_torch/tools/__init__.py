"""On-card validation tools, run as ``python3 -m dvbt_tpu_torch.tools.<name>``:
mode_grid_hw, ber_hw and ber_curves, the counterparts of the repo's
``tools/`` scripts."""
