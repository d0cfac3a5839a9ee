"""The benchmark of mpassit_tpu_torch: forecast hours through its CLI on an
NVIDIA H100, compared with a plain reference (``python3 -m portbench.run``;
``BENCHMARK.json`` lists the cells)."""
