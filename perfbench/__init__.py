"""The benchmark of ``ultra_pytorch_tpu_torch`` on one NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name:

* ``configs/<config>.json``: the model configuration as it is run;
* ``reference/<config>.py``: its plain PyTorch ranker (``param_shapes``,
  ``forward``), which imports nothing of the port;
* ``work/<config>.py``: the operations and bytes of its step;
* ``traffic/<traffic>.json``: the traffic mix, read by the driver it
  names (``drivers/<driver>.py``);
* ``workloads/<cell>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

``yardstick/`` holds what every cell shares: peaks, the data key
schedule, the click draws, the plain DLA step, the comparison, the trace
reduction. A new cell, configuration or metric adds files and entries.
"""
