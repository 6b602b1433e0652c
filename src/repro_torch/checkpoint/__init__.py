# Checkpoint and restart of the port (the counterpart of `repro/checkpoint/`).
