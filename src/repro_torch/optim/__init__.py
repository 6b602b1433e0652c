# Optimizers of the port (the counterpart of `repro/optim/`).
from repro_torch.optim.adamw import AdamW, cosine_warmup, global_norm
