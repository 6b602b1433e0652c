# Functional layers of the port (plain tensors in, plain tensors out): the
# LM stack's norms, FFN and attention, the MLP, and embeddings.
