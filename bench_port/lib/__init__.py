"""The benchmark's shared pieces: scene traffic, the work count, the
profiler's reduction, spans, and the comparison with the reference."""
