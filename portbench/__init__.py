"""The benchmark of ``rnet_torch``, the PyTorch and CUDA port, on NVIDIA H100s.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout on a machine with the cell's CUDA devices::

    python3 -m portbench.run --workload ofp.train.b512 --seed 2147483749 --seconds 40 --trace 0

* ``run.py``: the entry point and the result line;
* ``core.py``: cells, configurations, traffic mixes, limits, per-layer
  readers and entries found by name from the files below;
* ``configs/``, ``traffic/``, ``limits/``: one JSON file each;
* ``entries/``: the entries (``train``, ``eval``, ``serve``) that set a
  cell up from the seed, run its window and compare what it produced;
* ``metrics/``: one reader per per-layer metric;
* ``data.py``, ``reference.py``, ``ops.py``, ``trace.py``, ``readers.py``,
  ``port.py``: the yardstick (inputs, plain reference, operation counts and
  peaks, trace reduction) and the harness's reach into the port;
* ``calibrate.py``: the readings a cell's limits are set from;
  ``sweep.py``: the serving cell's knee.

Its tests run on the CPU at tiny sizes (``python -m pytest portbench/tests``);
those marked ``chip`` need a CUDA device and skip without one
(``python -m pytest portbench/tests -m chip`` on the card).
"""
