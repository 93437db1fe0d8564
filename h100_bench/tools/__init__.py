"""One-off measurements that set the benchmark's data: not run by a
benchmark run."""
