"""One reader a metric (or a family of metrics, the name's part before its
first dot): ``read(window)`` gives the value, or None where the run has
nothing to read. Each declares its ``UNIT`` and ``SOURCE``, and a per-layer
reader its ``LAYER`` and the end-to-end metric it ``MOVES`` in each cell
family (the name's part after the dot); the run refuses a reader whose
declarations differ from its entry in ``BENCHMARK.json``. A file whose name
starts with ``_`` is shared by readers and reads no metric of its own."""
