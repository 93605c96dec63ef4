"""The harness of the port's benchmark: it finds a cell's configuration,
traffic mix, checks and per-layer readers by the names in
``BENCHMARK.json``, builds the system under test from ``repro_torch``,
drives the mix for the measured window and judges the outputs against
:mod:`reference`."""
