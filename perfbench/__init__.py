"""The port's benchmark: seeded inputs, the plain reference, the FLOP and
byte count, the traffic drivers and the metric readers.  Entry point:
``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; the cells and metrics are listed in ``BENCHMARK.json``."""
