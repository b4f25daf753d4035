"""rtbench: the benchmark of skirt_tpu_torch, photon packets per second
through `OligoSimulation` on one NVIDIA card.

`python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the repository root runs one cell (run.py; the
cells, metrics and limits are described in PERF.md).  Configurations,
cells and per-layer metrics are files of their own (`configs/`,
`workloads/`, `metrics/`), found by the names in the root's
BENCHMARK.json.
"""
