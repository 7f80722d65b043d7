"""The benchmark's metric readers, one file each, named as in BENCHMARK.json."""
