"""The benchmark of ``metrics_tpu_torch`` on CUDA cards.

One command runs one cell (a configuration under a traffic mix) and prints one
JSON line::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m portbench.run`` works the same.) ``BENCHMARK.json`` at the root of
the checkout lists the cells and their metrics. Everything else is found by
name under this folder:

- ``configs/<config>.json``: the deployment, its source, the collection it
  builds and the data it makes;
- ``traffic/<mix>.json``: the loop the cell drives and its parameters;
- ``data/<kind>.py``: a generator of the inputs, on the device, from the seed;
- ``loops/<loop>.py``: the warm-up, the timed window and the traced units;
- ``reference/<config>.py``: the plain reference and the comparison that
  decides ``correct``;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader a
  metric;
- ``work/``: the operations and bytes a layer's work needs, and the card's
  published peaks.

Nothing here imports ``jax`` or the JAX package ``metrics_tpu``; the reference
imports nothing of ``metrics_tpu_torch`` either.
"""
