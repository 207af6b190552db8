"""gnnbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a configuration under a traffic mix) once::

    python3 gnnbench/run.py --workload gcn-b2-flickr.resident \
        --seed 7 --seconds 30 --trace 0

and prints one JSON line.  Everything that belongs to one configuration,
one traffic mix or one metric lives in a file of its own, found by the
name that ``BENCHMARK.json`` gives it:

* ``configs/<name>.json``: the deployment (graph, model widths, limits);
* ``models/<family>.py``: how the port's ``gnn_builders`` express the model and
  the work (operations and bytes) a request needs;
* ``reference/<family>.py``: the plain PyTorch reference;
* ``traffic/<name>.json``: the traffic mix;
* ``metrics/<name>.py``: one reader a metric.
"""
