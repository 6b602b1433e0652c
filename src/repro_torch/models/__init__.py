# Model definitions of the port: the dense decoder-only LM (transformer.py).
