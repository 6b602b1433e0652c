# Data pipelines of the port (the counterpart of `repro/data/`).
