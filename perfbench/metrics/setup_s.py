"""Seconds from the start of the benchmark's process to its first timed
call: imports, CUDA's start, the program and its kernels' library, the
inputs and the warm-up.  On a checkout's first run the library is built
with ``nvcc``, and that build counts here too; the run's set-up log gives
it as a phase of its own."""


def read(rec):
    return rec["window"]["setup_s"]
