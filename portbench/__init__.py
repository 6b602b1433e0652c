"""The port's end-to-end benchmark (`python3 portbench/run.py`).

`BENCHMARK.json` at the repository root names the cells; each cell's
configuration, traffic mix and metrics are files of this folder, found by
name (`harness.py`).  Nothing here imports JAX or the JAX package.
"""
