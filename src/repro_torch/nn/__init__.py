# Functional layers of the LM stack (plain tensors in, plain tensors out).
