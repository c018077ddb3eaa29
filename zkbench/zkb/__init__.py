"""The benchmark's harness: spec, traffic, the run loop, the trace and the check."""
