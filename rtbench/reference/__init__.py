"""The plain reference of the benchmark: one module per model family
(`expdisk.py`), each a straightforward Monte Carlo of the semantics its
configuration file states, written from that file alone.  Nothing here
imports the port, skirt_tpu, jax or the rest of rtbench
(test_rtbench_cpu.py checks so)."""
