"""The benchmark of the PyTorch and CUDA port (``ps_pytorch_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix, one cell's limits or one per-layer metric is a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the sizes as run; ``configs/<config>.py``
  beside it: the plain PyTorch reference of the model;
- ``traffic/<traffic>.json``: the parameters of one traffic mix, with the
  name of the driver that runs it (``drivers/<driver>.py``);
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: one per-layer metric's reader.
"""
