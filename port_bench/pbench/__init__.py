"""The port's benchmark harness: cell resolution, seeded content, the
driver of the encoder's API, the window arithmetic, the trace reduction
and the correctness check.  Run through ``port_bench/run.py``."""
