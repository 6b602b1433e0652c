"""Inputs the benchmark makes from `--seed`: the graph and the search keys."""
