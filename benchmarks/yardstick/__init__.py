"""What later changes to the program cannot move: the chip's peaks,
the byte and FLOP counts, the reduction of a profiler trace, the
recording of kernel launches and the comparisons that decide
``correct``."""
